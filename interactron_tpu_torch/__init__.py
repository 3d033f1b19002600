"""PyTorch/CUDA port of interactron-tpu for NVIDIA Hopper.

The package runs the adaptive `predict`, the policy `next_action` and the
second-order meta-train step (`grads_and_metrics` and the optimizer step in
`engine/trainer.py`) of the full `interactron` configuration. It imports torch and numpy only; the JAX
package `interactron_tpu` is its numerical reference and is never imported
here. Module and file names mirror `interactron_tpu/` so each counterpart is
easy to find.
"""
