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
    block_i/moe/{router,w1,w2}             -> blocks.i.moe.*
    ln_f/{scale,bias}                      -> ln_f.*

A quantized tree (`horovod_tpu.ops.quantization.quantize_lm_params`)
maps the same way: its ``kernel_q`` (int8) and ``kernel_scale`` (f32)
leaves land on the int8 model's buffers of those names.

`paged_pools_from_jax(pools)` maps the JAX package's paged KV pools
(`init_paged_pools`: one [num_blocks, 1, block_size, Hkv, D] array
per KV leaf of the decode cache, in flatten order) onto the port's
per-layer ``(k_pool, v_pool)`` pairs, or under int8 KV the
``(k_pool, v_pool, k_scale_pool, v_scale_pool)`` tuples, so both
packages can be fed the same cache state.

`adam_state_from_jax(opt_state, model)` maps an optax Adam/AdamW state
(its ``ScaleByAdamState``: ``count``, ``mu``, ``nu``) onto the per-param
``step``, ``exp_avg`` and ``exp_avg_sq`` of a `torch.optim.AdamW` (or
Adam) over the port model's parameters, so a JAX run's optimizer state
carries across with its weights.

`shard_state_dict(model, sd, mesh)` cuts a full state dict (from
`params_from_jax`, or a whole model's) into this rank's shard of a
tensor- or expert-parallel model, and `gather_state_dict` reassembles
it: the fused qkv leaves by `parallel.tensor.qkv_columns` (this rank's
q heads, then its k and v heads), every other leaf by its spec (the
experts' ``w1`` / ``w2`` over ``expert``).

`word2vec_params_from_jax(tree)` maps a `horovod_tpu.models.word2vec.
Word2Vec` param tree (``embeddings``, ``nce_weights``) onto the port's
`models.word2vec.Word2Vec`.

`powersgd_state_from_jax(state, params)` maps the JAX package's
`PowerSGDState` (``qs`` / ``errs``, one entry per param leaf in flatten
order, None where a leaf is not compressed) onto the per-parameter
``powersgd_q`` / ``powersgd_err`` entries of
`optim.DistributedOptimizer(compression="powersgd")`, so both packages
start from the same factors (the JAX Qs are threefry draws).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Sequence, Tuple

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
        if any(p in ("lora_a", "lora_b") for p in parts):
            raise NotImplementedError(
                f"param {'/'.join(path)}: LoRA weights are a later "
                f"slice of the PyTorch port (ROADMAP Queue A 6)")
        if arr.dtype.name == "bfloat16":   # ml_dtypes bf16 (serving casts)
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        sd[".".join(parts)] = t
    return sd


def paged_pools_from_jax(pools: Sequence) -> List[Tuple[torch.Tensor,
                                                       ...]]:
    """The port's per-layer pool tuples from the JAX package's pool list
    (numpy arrays [num_blocks, 1, block_size, ...], one per KV leaf in
    the decode cache's flatten order). Flatten order sorts the layer
    names as strings (``block_10`` before ``block_2``) and a layer's
    leaf names as strings: ``cached_key``, ``cached_value``, or under
    int8 KV ``cached_key``, ``cached_key_scale``, ``cached_value``,
    ``cached_value_scale`` (the scale pools are the 4-D leaves
    [num_blocks, 1, block_size, Hkv]). Returns ``(k_pool, v_pool)`` or
    ``(k_pool, v_pool, k_scale_pool, v_scale_pool)`` per layer, the
    singleton axis 1 dropped."""
    arrs = [np.asarray(a) for a in pools]
    quant = any(a.ndim == 4 for a in arrs)
    per = 4 if quant else 2
    if len(arrs) % per:
        raise ValueError(
            f"expected {per} pools per layer, got {len(arrs)} pools")
    n = len(arrs) // per
    order = sorted(range(n), key=lambda i: f"block_{i}")
    out: List = [None] * n
    for j, layer in enumerate(order):
        leaves = arrs[per * j:per * (j + 1)]
        if quant:   # (key, key_scale, value, value_scale) -> k, v, ks, vs
            leaves = [leaves[0], leaves[2], leaves[1], leaves[3]]
        tup = []
        for arr, nd in zip(leaves, (5, 5, 4, 4)):
            if arr.ndim != nd or arr.shape[1] != 1:
                raise ValueError(
                    f"pool leaf must be [num_blocks, 1, block_size, Hkv"
                    f"{', D' if nd == 5 else ''}], got {arr.shape}")
            if arr.dtype.name == "bfloat16":
                t = torch.from_numpy(arr.astype(np.float32)).to(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            tup.append(t[:, 0].contiguous())
        out[layer] = tuple(tup)
    return out


def _find_adam_state(node) -> Any:
    """The first ``count``/``mu``/``nu`` record in an optax state tree
    (a chain's state is a tuple of per-transformation states)."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None


def adam_state_from_jax(opt_state, model: torch.nn.Module
                        ) -> Dict[torch.nn.Parameter, Dict[str, Any]]:
    """Per-param AdamW state from an optax Adam/AdamW state of numpy
    arrays (``jax.tree.map(np.asarray, opt_state)``): ``{param: {"step":
    count, "exp_avg": mu, "exp_avg_sq": nu}}`` for every parameter of
    ``model``, on its device and dtype. optax's ``count`` and torch's
    ``step`` both count the updates applied, so the bias corrections
    agree. Install with ``optimizer.state.update(...)``."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the "
                         "optimizer state")
    mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)))
    out = {}
    for name, p in model.named_parameters():
        if name not in mu:
            raise KeyError(f"optimizer state has no moments for {name}")
        out[p] = {"step": step.clone(),
                  "exp_avg": mu[name].to(p.device, p.dtype),
                  "exp_avg_sq": nu[name].to(p.device, p.dtype)}
    return out


def word2vec_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A state_dict of the port's `Word2Vec` from the JAX model's param
    tree of numpy arrays; raises on any other leaf."""
    flat = _flatten(tree)
    want = {("embeddings",), ("nce_weights",)}
    if set(flat) != want:
        raise KeyError(f"expected Word2Vec params {sorted(want)}, got "
                       f"{sorted(flat)}")
    return {path[0]: torch.from_numpy(np.array(arr))
            for path, arr in flat.items()}


def _jax_path(name: str) -> tuple:
    """The JAX param path of a port parameter name (``blocks.3.attn.qkv.
    kernel`` -> ``block_3/attn/qkv/kernel``; other names map 1:1)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        parts = [f"block_{parts[1]}"] + parts[2:]
    return tuple(parts)


def powersgd_state_from_jax(state, params
                            ) -> Dict[torch.nn.Parameter, Dict[str, Any]]:
    """Per-param PowerSGD entries from a JAX `PowerSGDState` of numpy
    arrays (``jax.tree.map(np.asarray, state)``): ``{param:
    {"powersgd_q": q, "powersgd_err": err}}`` for every compressed leaf,
    in float32 on the parameter's device. ``params`` is the port model
    (or its ``named_parameters()``); the JAX leaves are matched by
    flatten order (param paths sorted, ``block_10`` before ``block_2``).
    Install with ``optimizer.state[p].update(...)``."""
    named = list(params.named_parameters() if hasattr(
        params, "named_parameters") else params)
    if len(named) != len(state.qs) or len(state.qs) != len(state.errs):
        raise ValueError(
            f"PowerSGD state holds {len(state.qs)} leaves but the model "
            f"has {len(named)} parameters")
    order = sorted(named, key=lambda kv: _jax_path(kv[0]))
    out = {}
    for (name, p), q, err in zip(order, state.qs, state.errs):
        if q is None:
            continue
        out[p] = {"powersgd_q": torch.from_numpy(np.array(q)).to(
                      p.device, torch.float32),
                  "powersgd_err": torch.from_numpy(np.array(err)).to(
                      p.device, torch.float32)}
    return out


def shard_state_dict(model, sd: Mapping[str, torch.Tensor],
                     mesh) -> Dict[str, torch.Tensor]:
    """This rank's state dict of the tensor- or expert-parallel ``model``
    over ``mesh`` from the FULL one ``sd`` (the whole model's names and
    shapes, e.g. `params_from_jax`'s). ``model`` gives the structure
    (sharded or not); the leaves come back on their input device."""
    from horovod_tpu_torch.models.transformer import lm_param_specs
    from horovod_tpu_torch.parallel.tensor import shard_params
    return shard_params(mesh, model, dict(sd), lm_param_specs(model))


def gather_state_dict(model, sd: Mapping[str, torch.Tensor],
                      mesh) -> Dict[str, torch.Tensor]:
    """The inverse of `shard_state_dict`: the whole model's state dict
    from every rank's shard ``sd`` (a collective over the mesh's
    ``model`` and ``expert`` axes: every rank of them calls it)."""
    from horovod_tpu_torch.models.transformer import tp_specs
    from horovod_tpu_torch.parallel.tensor import gather_params
    return gather_params(mesh, model, dict(sd), tp_specs(model, mesh))
