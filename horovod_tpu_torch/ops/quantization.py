"""Weight-only int8 quantization for inference, and the int8 KV codec.

Counterpart of `horovod_tpu.ops.quantization`, same arithmetic: the
transformer block matmul kernels (attention ``qkv``/``out``, the gelu
MLP's ``wi``/``wo``, the SwiGLU MLP's ``gate``/``up``/``down``) are
stored as int8 codes with one f32 scale per output channel; the
embedding, the positions, the LM head (tied or ``lm_head``) and the
norms stay at full precision. Decode reads every weight once per
token, so int8 kernels halve the bytes of the block matmuls' weights
at rest; the port dequantizes at the module dtype before each product
(`parallel.tensor._Dense`), outside any kernel, as the JAX package
leaves the dequant to XLA.

Codes and scales are bitwise the JAX codec's: ``amax / 127`` in f32,
round half to even, clamp to +-127, scale 1 for an all-zero channel.

Flow: ``qmodel = quantize_lm(model)`` — an int8 `TransformerLM`
built from a float one (the counterpart of
``model.clone(weight_quant="int8")`` plus `quantize_lm_params` of its
params). On state dicts: `quantize_lm_params` / `dequantize_lm_params`.
Oracle (tests/test_torch_port_quant.py): the quantized model equals the
float model loaded with `dequantize_lm_params` of its state dict at the
module dtype, bitwise.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# Module names whose 2-D ``kernel`` is quantized: the block matmuls of
# ParallelSelfAttention, ParallelMLP and ParallelSwiGLU.
QUANT_KERNEL_MODULES = ("qkv", "out", "wi", "wo", "gate", "up", "down")


def check_quant(knob: str, value):
    """``value`` of the ``knob`` (weight_quant / kv_quant) is None or
    "int8"; anything else raises the reference's ValueError."""
    if value not in (None, "int8"):
        raise ValueError(f"unsupported {knob} {value!r}")
    return value


def quantize_int8(w: torch.Tensor, axis: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``axis``, the contraction axis
    (0 for the [in, out] dense kernels; -1, the head dim, for KV rows):
    returns ``(q int8, scale f32)`` with the ``axis`` dim squeezed out
    of the scale, ``|w - q * scale| <= scale / 2`` elementwise."""
    amax = w.abs().amax(dim=axis, keepdim=True).float()
    # A tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which is not bitwise the reference's division.
    scale = torch.where(amax == 0, 1.0, amax / torch.full_like(amax, 127.0))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(axis)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32, axis: int = 0) -> torch.Tensor:
    """``q * scale`` at ``dtype``: both cast to ``dtype`` first, then one
    product (the scale re-expanded on ``axis``)."""
    return q.to(dtype) * scale.unsqueeze(axis).to(dtype)


def _quant_site(name: str, t: torch.Tensor) -> bool:
    parts = name.split(".")
    return (len(parts) >= 2 and parts[-1] == "kernel"
            and parts[-2] in QUANT_KERNEL_MODULES and t.ndim == 2)


def quantize_lm_params(sd: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """A float `TransformerLM` state dict into the int8 model's: each
    block-matmul ``<module>.kernel`` becomes ``<module>.kernel_q`` (int8
    [in, out]) and ``<module>.kernel_scale`` (f32 [out]); every other
    entry passes through."""
    out = {}
    for name, t in sd.items():
        if _quant_site(name, t):
            base = name[:-len("kernel")]
            out[base + "kernel_q"], out[base + "kernel_scale"] = (
                quantize_int8(t, axis=0))
        else:
            out[name] = t
    return out


def dequantize_lm_params(sd: Dict[str, torch.Tensor],
                         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The inverse structural transform (the oracle's reference path):
    each ``kernel_q`` / ``kernel_scale`` pair back to a ``kernel`` at
    ``dtype``."""
    out = {}
    for name, t in sd.items():
        if name.endswith(".kernel_scale"):
            continue
        if name.endswith(".kernel_q"):
            base = name[:-len("kernel_q")]
            out[base + "kernel"] = dequantize_int8(
                t, sd[base + "kernel_scale"], dtype)
        else:
            out[name] = t
    return out


def quantize_lm(model):
    """An int8-weight `TransformerLM` from a float one: the same
    configuration with ``weight_quant="int8"``, its block kernels
    quantized from ``model``'s and every other tensor shared with
    ``model`` (same storage, dtype and device). A model that is already
    int8 is returned as it is."""
    if model.weight_quant == "int8":
        return model
    qmodel = model.clone(weight_quant="int8")
    qmodel.load_state_dict(quantize_lm_params(model.state_dict()),
                           assign=True)
    return qmodel.train(model.training)
