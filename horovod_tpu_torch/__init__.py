"""horovod_tpu_torch — the PyTorch/CUDA port of `horovod_tpu`.

A package of its own beside the JAX one: it imports `torch`, never
`jax`, and nothing of `horovod_tpu`. Its layout mirrors the JAX
package's so each module's counterpart is easy to find. This slice
serves the flagship LM (`models.transformer.TransformerLM`) through
`serving.ServingEngine` on one NVIDIA H100, with the flash-forward and
flash-decode kernels hand-written in CUDA for Hopper (`csrc/`).

Entry points run on the card unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper uses its plain PyTorch version.
"""

__version__ = "0.1.0"
