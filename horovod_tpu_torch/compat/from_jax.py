"""Load the JAX package's `TransformerLM` weights into the port.

`params_from_jax(tree)` maps the flax param tree of a
`horovod_tpu.models.transformer.TransformerLM` — given as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, params)``; nothing of JAX is
imported here) — onto the state_dict of the port's `TransformerLM`.
Dense kernels keep their [in, out] layout, so every leaf maps one to
one:

    embed, pos, lm_head                    -> same name
    block_i/ln_attn|ln_mlp/{scale,bias}    -> blocks.i.ln_attn|ln_mlp.*
    block_i/attn/{qkv,out}/{kernel,bias}   -> blocks.i.attn.{qkv,out}.*
    block_i/mlp/{wi,wo,gate,up,down}/...   -> blocks.i.mlp.*
    ln_f/{scale,bias}                      -> ln_f.*
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"^block_(\d+)$")


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A port state_dict from a flax `TransformerLM` param tree of numpy
    arrays (the ``params`` collection, unboxed). Raises on any leaf it
    cannot place; load with ``model.load_state_dict(sd)`` (strict)."""
    sd = {}
    for path, arr in _flatten(tree).items():
        parts = list(path)
        m = _BLOCK.match(parts[0])
        if m:
            parts = ["blocks", m.group(1)] + parts[1:]
        elif parts[0] not in ("embed", "pos", "lm_head", "ln_f"):
            raise KeyError(f"unexpected param {'/'.join(path)}")
        if any(p in ("kernel_q", "kernel_scale", "lora_a", "lora_b", "moe")
               for p in parts):
            raise NotImplementedError(
                f"param {'/'.join(path)}: int8, LoRA and MoE weights are "
                f"later slices of the PyTorch port")
        if arr.dtype.name == "bfloat16":   # ml_dtypes bf16 (serving casts)
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        sd[".".join(parts)] = t
    return sd
