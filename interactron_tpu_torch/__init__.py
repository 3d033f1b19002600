"""PyTorch/CUDA port of interactron-tpu for NVIDIA Hopper.

The package runs the adaptive `predict` and the policy `next_action` of the
full `interactron` configuration. It imports torch and numpy only; the JAX
package `interactron_tpu` is its numerical reference and is never imported
here. Module and file names mirror `interactron_tpu/` so each counterpart is
easy to find.
"""
