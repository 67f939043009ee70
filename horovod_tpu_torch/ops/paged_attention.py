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
  ticks) and is the oracle of the kernel; under int8 KV (scale pools)
  it dequantizes each span, and the kernel is never called.
* `paged_decode_plain` — the plain version of the paged-decode kernel:
  the walk at ``walk_block == block_size`` with S = 1.
* `paged_decode_split_plain` — the kernel's split-and-merge arithmetic
  in PyTorch (each lane's table cut into `paged_decode_splits` ranges,
  partials merged in f32), for the tests.
* `paged_decode_cuda` — the wrapper of the hand-written CUDA kernels
  (``csrc/paged_decode.cu``: the split kernel, then the merge of its
  partials); counts its calls in ``.launches`` and keeps the split
  count of the last call in ``.splits_last``.
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
    NEG_INF, _DTYPE_CODE, _F, _I, _L, _P, _check_decode_group,
    _check_head_dim, _check_kernel_operand, _lib_call, _sm_count,
    decode_splits,
)
from horovod_tpu_torch.ops.quantization import dequantize_int8


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
                           prefix_len: Optional[int] = None,
                           k_scale_pool=None, v_scale_pool=None,
                           compute_dtype=None):
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

    int8 KV: the pools are int8 and ``k_scale_pool``/``v_scale_pool``
    [num_blocks, block_size, Hkv] f32 hold the per-(position, head)
    scales; each span is dequantized at ``compute_dtype`` (default
    q.dtype) before the call's rows are merged in. Those rows are
    already through the codec (quantized and read back at the compute
    dtype): exactly the bytes a gathered view would hold.
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
    cdtype = compute_dtype or dtype
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

        def read(pool, spool, new):
            blk = pool[bids].reshape(L, walk_block, Hkv, D)
            if spool is not None:
                blk = dequantize_int8(
                    blk, spool[bids].reshape(L, walk_block, Hkv), cdtype,
                    axis=-1)
            blk = torch.where(ins, new[lanes, idx].to(blk.dtype), blk)
            return (blk.repeat_interleave(groups, dim=2) if groups > 1
                    else blk)

        kb = read(k_pool, k_scale_pool, k_new)
        vb = read(v_pool, v_scale_pool, v_new)
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


# Table entries one split of the kernel stages in shared memory
# (``csrc/paged_decode.cu``: MAX_CE). `paged_decode_splits` stays below
# it: its splits hold at most 512 positions, or the whole table when
# the span is under 1024 positions.
PAGED_MAX_SPLIT_ENTRIES = 1024


def paged_decode_splits(T: int, bs: int, pairs: int, n_sm: int) -> int:
    """Ranges the paged-decode kernel cuts each lane's table of ``T``
    entries into: `decode_splits` over the table's span of ``T * bs``
    positions for ``pairs`` (kv heads x lanes) blocks on ``n_sm`` SMs,
    then whole entries: a split holds ce = ceil(T / NS) entries (ce * bs
    positions, whole pool blocks) and NS = ceil(T / ce), so none starts
    past the table. Picked from the geometry, never from the fills:
    reading those would sync the tick."""
    ce = -(-T // decode_splits(T * bs, pairs, n_sm))
    return -(-T // ce)


def paged_decode_split_plain(q, k_new, v_new, table, fill, k_pool, v_pool,
                             splits: int):
    """The paged-decode kernel's arithmetic in PyTorch: cut each lane's
    table into ``splits`` ranges of ce = ceil(T / splits) entries, form
    each range's partial over the lane's positions ``<= fill`` (within
    the table's span, ``k_new``/``v_new`` in place of the row at
    ``fill``): row max m_s, row sum l_s of the unrounded p, and o_s, the
    sum of p rounded to q.dtype times V; then merge in f32, skipping
    empty ranges: ``o = sum e^(m_s - M) o_s / sum e^(m_s - M) l_s`` with
    M = max m_s. q is scaled and rounded to q.dtype as in
    `paged_decode_plain`. Returns [L, H, D] at q.dtype."""
    L, H, D, Hkv, bs, T = _decode_shapes(q, k_new, v_new, table, fill,
                                         k_pool, v_pool)
    grp = H // Hkv
    dtype = q.dtype
    dev = q.device
    ce = -(-T // splits)
    P = splits * ce * bs                      # positions, the last padded
    fill = fill.long()
    qs = (q * torch.tensor(D ** -0.5, dtype=dtype)).float()
    entries = torch.nn.functional.pad(table.long(), (0, splits * ce - T))
    pos = torch.arange(P, device=dev)
    cur = (pos[None, :] == fill[:, None])[..., None, None]     # [L, P, 1, 1]

    def rows(pool, new):
        r = pool[entries].reshape(L, P, Hkv, D)
        r = torch.where(cur, new[:, None].to(r.dtype), r).float()
        return r.repeat_interleave(grp, dim=2) if grp > 1 else r

    s = torch.einsum("lhd,lphd->lhp", qs, rows(k_pool, k_new))
    npos = (fill + 1).clamp(max=T * bs)
    s = s.masked_fill(~(pos[None, :] < npos[:, None])[:, None], NEG_INF)
    s = s.unflatten(-1, (splits, ce * bs))                     # [L,H,NS,C]
    m = s.amax(-1)
    empty = m == NEG_INF
    p = torch.exp(s - torch.where(empty, 0.0, m)[..., None])
    l = p.sum(-1)
    v = rows(v_pool, v_new).transpose(1, 2).unflatten(2, (splits, ce * bs))
    o = torch.einsum("lhsc,lhscd->lhsd", p.to(dtype).float(), v)
    top = m.amax(-1, keepdim=True)
    wt = torch.where(empty, 0.0, torch.exp(m - torch.where(
        top == NEG_INF, 0.0, top)))
    den = (wt * l).sum(-1, keepdim=True)
    out = (wt[..., None] * o).sum(2) / torch.where(den == 0, 1.0, den)
    return out.to(dtype)


# q, k_new, v_new, table, fill, k_pool, v_pool, out, workspace; dtype, L,
# H, Hkv, D, block_size, T, splits; the (lane, head) strides of q,
# k_new, v_new; scale; stream.
_PAGED_ARGTYPES = [_P] * 9 + [_I] * 8 + [_L] * 6 + [_F, _P]


def _check_index(name, t, shape, dev):
    if not (isinstance(t, torch.Tensor) and t.dtype == torch.int32
            and t.device == dev and tuple(t.shape) == shape
            and t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous int32 tensor {list(shape)} on "
            f"{dev}, got {getattr(t, 'dtype', type(t))} "
            f"{tuple(getattr(t, 'shape', ()))}")


def paged_decode_cuda(q, k_new, v_new, table, fill, k_pool, v_pool, *,
                      splits: Optional[int] = None):
    """Launch the paged-decode kernels (``csrc/paged_decode.cu``: the
    split kernel, then the merge of its partials): q [L, H, D] and
    k_new/v_new [L, Hkv, D] (strided, 16-byte aligned rows with a
    contiguous head dim), ``table`` [L, T] and ``fill`` [L] contiguous
    device int32, pools [num_blocks, block_size, Hkv, D] contiguous.
    D must be 64, 128 or 256 and H/Hkv 1 to 8. Every table entry a lane
    reaches must name a block of the pool (the kernel does not
    bound-check block ids). ``splits`` (default: `paged_decode_splits`
    of the geometry) is how many ranges each lane's table is cut into;
    the partials go to a workspace allocated here on the current
    stream."""
    L, H, D, Hkv, bs, T = _decode_shapes(q, k_new, v_new, table, fill,
                                         k_pool, v_pool)
    if q.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, "
                         f"got {q.dtype}")
    _check_head_dim(D)
    _check_decode_group("paged-decode", H, Hkv)
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new),
                    ("k_pool", k_pool), ("v_pool", v_pool)):
        _check_kernel_operand(name, t, q)
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged-decode pools must be contiguous")
    _check_index("table", table, (L, T), q.device)
    _check_index("fill", fill, (L,), q.device)
    if splits is None:
        splits = paged_decode_splits(T, bs, Hkv * L, _sm_count(q.device))
    elif not (1 <= splits and -(-T // splits) <= PAGED_MAX_SPLIT_ENTRIES):
        raise ValueError(
            f"splits must cut the {T}-entry table into ranges of at most "
            f"{PAGED_MAX_SPLIT_ENTRIES} entries, got {splits}")
    out = torch.empty((L, H, D), dtype=q.dtype, device=q.device)
    if L == 0:
        return out
    ws = torch.empty(splits * L * H * (D + 2), dtype=torch.float32,
                     device=q.device)
    # q is scaled at the compute dtype, as the plain version does.
    scale = float(torch.tensor(D ** -0.5, dtype=q.dtype))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _lib_call(
            "paged_decode", _PAGED_ARGTYPES,
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            table.data_ptr(), fill.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), out.data_ptr(), ws.data_ptr(),
            _DTYPE_CODE[q.dtype], L, H, Hkv, D, bs, T, splits, q.stride(0),
            q.stride(1), k_new.stride(0), k_new.stride(1), v_new.stride(0),
            v_new.stride(1), scale, stream)
    paged_decode_cuda.launches += 1
    paged_decode_cuda.splits_last = splits
    return out


paged_decode_cuda.launches = 0
paged_decode_cuda.splits_last = None


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
