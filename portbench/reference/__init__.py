"""The plain reference of the port: plain PyTorch in fp32 (TF32 off when
the caller runs it under portbench.lib.precision.fp32), a frozen copy of
the port's model code with one formulation of each layer. It imports
nothing of the program (`interactron_tpu_torch`), of JAX or of the JAX
package, and takes nothing the program made: the caller hands it the
weights and inputs it also hands the program."""
