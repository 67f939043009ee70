"""Paged attention for the port: decode attention that reads the KV
pool THROUGH each lane's block table, touching only the filled blocks.

Counterpart of `horovod_tpu.ops.paged_attention`, batched over lanes
(the JAX package vmaps a one-lane function; here every function takes
the lane axis first):

* `paged_prefix_attention` — the block-table walk in plain PyTorch:
  each step gathers only the ``walk_block / block_size`` table entries
  that cover its span and applies the online-softmax update of
  `ParallelSelfAttention._prefix_attention`. The trip count follows a
  host-known upper bound on the fills (``prefix_len``), so no host
  sync reads the device fills. It serves S >= 1 (prefill chunks and
  ticks) and is the oracle of the kernel.
* `paged_decode_plain` — the plain version of the paged-decode kernel:
  the walk at ``walk_block == block_size`` with S = 1.
* `paged_decode_cuda` — the wrapper of the hand-written CUDA kernel
  (``csrc/paged_decode.cu``); counts its launches in ``.launches``.
* `paged_decode_attention` — the dispatcher: a CPU tensor takes the
  plain version, a CUDA tensor launches the kernel or raises.

Pool layout: ``[num_blocks, block_size, Hkv, D]`` per layer and per K/V
(the JAX pool leaf without its singleton axis 1). Block 0 is the null
block: never allocated to a sequence, never attended. ``table`` [L, T]
int32 and ``fill`` [L] int32 live on the pool's device. The current
call's K/V rows (``k_new``/``v_new``) are merged at positions
``fill .. fill + S - 1`` inside the walk, so the pool may still hold
stale bytes there: the caller writes the new rows after attention.
"""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS, _DTYPE_CODE, _F, _I, _L, _P, _check_kernel_operand,
    _lib_call,
)


def _pool_geometry(k_pool, v_pool, table):
    if k_pool.ndim != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"pools must be [num_blocks, block_size, Hkv, D] and equal, "
            f"got {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if table.ndim != 2:
        raise ValueError(f"table must be [lanes, T], got "
                         f"{tuple(table.shape)}")
    return k_pool.shape[1], table.shape[1]


def paged_prefix_attention(q, k_new, v_new, k_pool, v_pool, table, fill,
                           *, walk_block: int,
                           prefix_len: Optional[int] = None):
    """Attention of ``q`` (positions ``fill .. fill+S-1`` of each lane)
    against a paged cache, walking only the filled blocks of ``table``.

    q [L, S, H, D]; k_new/v_new [L, S, Hkv, D], the current call's rows
    (already rotated, at the pool dtype); pools [num_blocks, block_size,
    Hkv, D]; ``table`` [L, T] and ``fill`` [L] int32 on the pools'
    device. ``walk_block`` is the accumulation granularity, a multiple
    of the block size dividing the table span. ``prefix_len``: a
    host-side upper bound on every lane's ``fill + S`` (None: walk the
    whole table); a span wholly past a lane's fill is masked to the f32
    minimum and leaves its m, l and acc bit-for-bit unchanged, so the
    bound changes the trip count and never the result. The walk stops
    at the table's end: a lane at ``fill == T * block_size`` (the
    pipelined tick past the budget) attends its whole table and no new
    row. q scaled in the compute dtype and p rounded to the cache dtype
    before P.V, as the JAX walk does. Returns [L, S, H, D] at q.dtype.
    """
    L, S, H, D = q.shape
    bs, T = _pool_geometry(k_pool, v_pool, table)
    Hkv = k_pool.shape[2]
    span = T * bs
    if walk_block < bs or walk_block % bs or span % walk_block:
        raise ValueError(
            f"walk_block ({walk_block}) must be a positive multiple of "
            f"the pool block size ({bs}) dividing the table span "
            f"({span})")
    if H % Hkv:
        raise ValueError(f"H={H} not divisible by Hkv={Hkv}")
    groups = H // Hkv
    r = walk_block // bs
    dtype = q.dtype
    dev = q.device
    qs = (q * torch.tensor(D ** -0.5, dtype=dtype)).float()
    fill = fill.long()
    qpos = fill[:, None] + torch.arange(S, device=dev)        # [L, S]
    neg = torch.finfo(torch.float32).min
    m = torch.full((L, H, S), neg, device=dev)
    l = torch.zeros(L, H, S, device=dev)
    acc = torch.zeros(L, H, S, D, device=dev)
    lanes = torch.arange(L, device=dev)[:, None]
    offs = torch.arange(walk_block, device=dev)
    stop = span if prefix_len is None else min(span, max(1, prefix_len))
    for start in range(0, stop, walk_block):
        bids = table[:, start // bs:start // bs + r].long()   # [L, r]
        rel = start + offs[None, :] - fill[:, None]          # [L, wb]
        ins = ((rel >= 0) & (rel < S))[..., None, None]
        idx = rel.clamp(0, S - 1)

        def read(pool, new):
            blk = pool[bids].reshape(L, walk_block, Hkv, D)
            blk = torch.where(ins, new[lanes, idx].to(blk.dtype), blk)
            return (blk.repeat_interleave(groups, dim=2) if groups > 1
                    else blk)

        kb = read(k_pool, k_new)
        vb = read(v_pool, v_new)
        logits = torch.einsum("lqhd,lkhd->lhqk", qs, kb.float())
        keep = (start + offs)[None, None, :] <= qpos[:, :, None]
        logits = torch.where(keep[:, None], logits, neg)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "lhqk,lkhd->lhqd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / l[..., None]
    return out.transpose(1, 2).to(dtype)


def _decode_shapes(q, k_new, v_new, table, fill, k_pool, v_pool):
    bs, T = _pool_geometry(k_pool, v_pool, table)
    if q.ndim != 3:
        raise ValueError(f"q must be [L, H, D], got {tuple(q.shape)}")
    L, H, D = q.shape
    Hkv = k_pool.shape[2]
    if k_pool.shape[3] != D or k_new.shape != (L, Hkv, D) \
            or v_new.shape != (L, Hkv, D):
        raise ValueError(
            f"k_new/v_new must be [L={L}, Hkv={Hkv}, D={D}] matching "
            f"the pools {tuple(k_pool.shape)}, got "
            f"{tuple(k_new.shape)}/{tuple(v_new.shape)}")
    if table.shape[0] != L or fill.shape != (L,):
        raise ValueError(f"table [L, T] / fill [L] must have L={L}, got "
                         f"{tuple(table.shape)}/{tuple(fill.shape)}")
    if H % Hkv:
        raise ValueError(f"H={H} not divisible by Hkv={Hkv}")
    return L, H, D, Hkv, bs, T


def paged_decode_plain(q, k_new, v_new, table, fill, k_pool, v_pool):
    """The plain version of the paged-decode kernel: the walk at
    ``walk_block == block_size`` with S = 1 over the whole table. Each
    lane attends positions ``<= fill`` of the first ``min(ceil((fill +
    1) / block_size), T)`` table entries, with ``k_new``/``v_new`` in
    place of the row at ``fill``. Returns [L, H, D] at q.dtype."""
    _decode_shapes(q, k_new, v_new, table, fill, k_pool, v_pool)
    return paged_prefix_attention(
        q[:, None], k_new[:, None], v_new[:, None], k_pool, v_pool,
        table, fill, walk_block=k_pool.shape[1])[:, 0]


_PAGED_ARGTYPES = [_P] * 8 + [_I] * 7 + [_L] * 6 + [_F, _P]


def _check_index(name, t, shape, dev):
    if not (isinstance(t, torch.Tensor) and t.dtype == torch.int32
            and t.device == dev and tuple(t.shape) == shape
            and t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous int32 tensor {list(shape)} on "
            f"{dev}, got {getattr(t, 'dtype', type(t))} "
            f"{tuple(getattr(t, 'shape', ()))}")


def paged_decode_cuda(q, k_new, v_new, table, fill, k_pool, v_pool):
    """Launch the paged-decode kernel (``csrc/paged_decode.cu``): q
    [L, H, D] and k_new/v_new [L, Hkv, D] (strided, contiguous head
    dim), ``table`` [L, T] and ``fill`` [L] contiguous device int32,
    pools [num_blocks, block_size, Hkv, D] contiguous. H/Hkv must be 1,
    2, 4 or 8. Every table entry a lane reaches must name a block of
    the pool (the kernel does not bound-check block ids)."""
    L, H, D, Hkv, bs, T = _decode_shapes(q, k_new, v_new, table, fill,
                                         k_pool, v_pool)
    if q.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, "
                         f"got {q.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel head_dim must be one of "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if H // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"paged-decode kernel takes 1, 2, 4 or 8 query "
                         f"heads per kv head, got {H // Hkv}")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new),
                    ("k_pool", k_pool), ("v_pool", v_pool)):
        _check_kernel_operand(name, t, q)
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged-decode pools must be contiguous")
    _check_index("table", table, (L, T), q.device)
    _check_index("fill", fill, (L,), q.device)
    out = torch.empty((L, H, D), dtype=q.dtype, device=q.device)
    if L == 0:
        return out
    # q is scaled at the compute dtype, as the plain version does.
    scale = float(torch.tensor(D ** -0.5, dtype=q.dtype))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _lib_call(
            "paged_decode", _PAGED_ARGTYPES,
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            table.data_ptr(), fill.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype], L,
            H, Hkv, D, bs, T, q.stride(0), q.stride(1), k_new.stride(0),
            k_new.stride(1), v_new.stride(0), v_new.stride(1), scale,
            stream)
    paged_decode_cuda.launches += 1
    return out


paged_decode_cuda.launches = 0


def paged_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, table: torch.Tensor,
                           fill: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor) -> torch.Tensor:
    """One S=1 decode tick of paged attention over every lane: q
    [L, H, D], the current token's k_new/v_new [L, Hkv, D], the block
    tables [L, T] and fills [L] (int32, on q's device), the pools
    [num_blocks, block_size, Hkv, D]. Returns [L, H, D] at q.dtype.
    CPU tensors take `paged_decode_plain`; CUDA tensors launch the
    kernel (or raise)."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_new, v_new, table, fill, k_pool,
                                  v_pool)
    return paged_decode_cuda(q, k_new, v_new, table, fill, k_pool, v_pool)
