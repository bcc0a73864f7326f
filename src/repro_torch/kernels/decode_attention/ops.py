"""Wrappers around the CUDA flash-decode kernel
(`csrc/decode_attention.cu`).

* `decode_attention_fwd(q, k, v, valid)` takes the Pallas function's
  layout: q (B·KH, G, D), k and v (B·KH, W, D), valid (B·KH, W) int32.
  A row without any valid slot is refused on every device (checking it
  reads ``valid``, a host sync on the card).
* `decode_attention(q, ck, cv, index, *, window)` is the model's entry:
  q (B, 1, H, D) of the token at absolute position ``index`` (a Python
  int), ck and cv (B, W, KH, D) ring caches with RoPE applied at write.
  The validity comes from `ref.ring_validity`; the token's own slot is
  always valid, so no row is empty and nothing is read back.  On the card
  the kernel reads the caches where they lie (no per-layer transpose or
  cast), so the call costs no copy of the cache.

K and V may be float32, bfloat16 or float8_e4m3fn (the last with a
bfloat16 or float32 q); they are taken in q's type, as the reference's
wrapper casts the cache: on the card the kernel widens each float8
element exactly as it reads it, so no widened copy of the ring is made.
The output is in q's type.  On a CUDA tensor the hand-written kernel
runs, built at first use with ``nvcc`` into ``build/kernels/`` of the
checkout and bound with `ctypes`: a call is one launch of thread-block
clusters, one per (row, 16 q heads), whose CTAs split the row's whole
64-key blocks and merge their pieces through distributed shared memory
(`plan` sizes it), and adds one to ``decode_attention_fwd.launches``.
The plan of a shape is made once and kept (`_PLANS`), so a call costs
its checks, the output's allocation and one C call.  On a CPU tensor the
plain version in `ref.py` runs and nothing is counted.  There is no
fallback: a CUDA tensor gets the kernel or an exception.

The kernel has no backward, as the reference's ``pallas_call`` has
none: with grad enabled and an input that requires it, every entry
raises on every device (`_build.refuse_grad`) rather than drop the
gradient; the model's differentiable path is its plain one.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from .._build import Library, check_tensor, raise_on, refuse_grad, stream_of
from .ref import decode_attention_ref, ring_validity

# the plain path (decoding is never differentiated in the model)
DECODE_PLAIN = "attn_impl='dense' (the grouped einsum over the ring)"

_DTYPES = (torch.float32, torch.bfloat16)
# the cache types the kernel reads, by its launcher's code
KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
MAX_HEAD_DIM = 256
BLOCK_KEYS = 64                         # a CTA's run is whole blocks of these
HEADS = 16                              # q heads of one cluster
STAGES = 3                              # the bulk-copy ring
MAX_CLUSTER = 16                        # CTAs of a cluster (non-portable > 8)
SMEM_LIMIT = 232448                     # a block's opt-in shared memory


class _PlanArgs(ctypes.Structure):
    """The C launcher's ``DecodePlan``, field for field."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "instance", "rows", "G", "W", "D", "kh", "valid_stride", "n_blocks",
        "cluster", "head_blocks")] + [("scale", ctypes.c_float)]


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_prepare.argtypes = [I, I, ctypes.POINTER(I),
                                             ctypes.POINTER(I),
                                             ctypes.POINTER(I)]
    lib.decode_attention_prepare.restype = I
    lib.decode_attention_run.argtypes = [P, P, P, P, P, P, P]
    lib.decode_attention_run.restype = I


LIBRARY = Library(Path(__file__).resolve().parent / "csrc"
                  / "decode_attention.cu", _declare)


def library() -> ctypes.CDLL:
    """The kernel's shared library, built if needed and loaded once per
    process."""
    return LIBRARY.load()


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# the launch plan (pure Python: mirrors the source's `Layout` and runs)
# ---------------------------------------------------------------------------
def padded_width(D: int) -> int:
    """The kernel instance's width: D padded to 64, 128 or 256."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


def tile_keys(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> int:
    """Keys of a ring stage: 32 where q or the cache is float32, else 64."""
    return 32 if torch.float32 in (q_dtype, kv_dtype) else 64


def smem_bytes(q_dtype: torch.dtype, kv_dtype: torch.dtype, D: int) -> int:
    """Dynamic shared memory of one CTA (the source's ``Layout::kBytes``):
    the ring's K and V tiles of every stage (8 groups of tile_keys / 8
    rows, 16 bytes of padding a group), a widened bfloat16 tile for a
    float8 cache under bfloat16 q, Q, two tiles of scores (bfloat16 q) or
    the scores and P (float32 q), the per-head rescale and the full and
    empty mbarriers."""
    qb = 2 if q_dtype == torch.bfloat16 else 4
    gb = torch.empty(0, dtype=kv_dtype).element_size()
    dp, tk = padded_width(D), tile_keys(q_dtype, kv_dtype)
    ring = 2 * STAGES * 8 * (tk // 8 * dp * gb + 16)
    wide = 2 * 8 * (tk // 8 * dp * 2 + 16) if (qb == 2 and gb == 1) else 0
    scores = 2 * 4 * HEADS * (tk + 4)
    return (ring + wide + qb * HEADS * (dp + 16 // qb) + scores + 4 * HEADS
            + 16 * STAGES)


def instance(q_dtype: torch.dtype, kv_dtype: torch.dtype, D: int) -> int:
    """The launcher's kernel instance: (q bf16, cache type, width)."""
    width = {64: 0, 128: 1, 256: 2}[padded_width(D)]
    return ((int(q_dtype == torch.bfloat16) * 3 + KV_TYPES[kv_dtype]) * 3
            + width)


class Plan(NamedTuple):
    """How one shape is launched.  ``cluster`` CTAs per (row, 16 q heads),
    ``head_blocks`` = ceil(G / 16) such clusters per row; the
    row's ``blocks`` 64-key blocks split into runs (`cta_runs`) of at most
    ``keys_per_cta`` keys, walked in tiles of ``tile_keys`` through a ring
    of ``stages``; ``bulk``: a cache row is a multiple of 16 bytes, so K
    and V arrive by copies (given 16-byte aligned pointers, which the
    launcher checks per call), else by element loads; ``in_flight``: the
    bytes of K and V a CTA has in flight once its ring is full;
    ``per_sm``: CTAs an SM holds; ``resident``: clusters of this size
    that can run at once on the card (None for a plan made without
    one)."""
    cluster: int
    head_blocks: int
    blocks: int
    keys_per_cta: int
    tile_keys: int
    stages: int
    width: int
    smem: int
    bulk: bool
    in_flight: int
    instance: int
    per_sm: int
    resident: Optional[int]


def cta_runs(W: int, blocks: int, cluster: int):
    """[(first slot, end slot)] of each CTA of a cluster: CTA r takes the
    whole blocks [r blocks / C, (r + 1) blocks / C), as the kernel does."""
    return [(r * blocks // cluster * BLOCK_KEYS,
             min(W, (r + 1) * blocks // cluster * BLOCK_KEYS))
            for r in range(cluster)]


def plan(rows: int, G: int, W: int, D: int, kh: int, q_dtype: torch.dtype,
         kv_dtype: torch.dtype, sms: int,
         resident: Optional[Callable[[int], int]] = None,
         per_sm: int = 1) -> Plan:
    """The launch of a (rows, G, W, D) call with ``kh`` kv heads a batch
    row on a card of ``sms`` SMs that hold ``per_sm`` CTAs each.  The
    cluster size C aims rows x head_blocks x C at one CTA per slot, at most
    16 and at most one CTA per 64-key block (so no run is empty), and then
    shrinks until every cluster is resident at once: ``resident(C)`` gives
    how many clusters of C fit the card (on the card, the occupancy
    calculator; by default ``sms per_sm // C``)."""
    del kh                              # rows of any stride plan alike
    blocks = -(-W // BLOCK_KEYS)
    slots = sms * per_sm
    head_blocks = -(-G // HEADS)
    per_row = rows * head_blocks
    fits = resident or (lambda c: slots // c)
    C = max(1, min(MAX_CLUSTER, blocks, slots // max(per_row, 1)))
    while C > 1 and fits(C) < per_row:
        C -= 1
    tk = tile_keys(q_dtype, kv_dtype)
    kv_bytes = torch.empty(0, dtype=kv_dtype).element_size()
    keys = -(-blocks // C) * BLOCK_KEYS
    longest = max(e - b for b, e in cta_runs(W, blocks, C))
    return Plan(cluster=C, head_blocks=head_blocks,
                blocks=blocks, keys_per_cta=keys, tile_keys=tk,
                stages=STAGES, width=padded_width(D),
                smem=smem_bytes(q_dtype, kv_dtype, D),
                bulk=D * kv_bytes % 16 == 0,
                in_flight=2 * min(longest, STAGES * tk) * D * kv_bytes,
                instance=instance(q_dtype, kv_dtype, D), per_sm=per_sm,
                resident=fits(C) if resident else None)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------
_PLANS = {}     # (rows, G, W, D, kh, valid stride, q, kv, device) -> launch
_OCCUPANCY = {}  # (instance, cluster, device index) -> (per SM, resident)


def _occupancy(lib, inst: int, dev: torch.device, smem: int, C: int):
    """(CTAs an SM holds, clusters of C CTAs resident at once) of instance
    ``inst`` on ``dev``, setting the instance's attributes there on first
    use."""
    key = (inst, C, dev.index)
    if key not in _OCCUPANCY:
        got_smem, per_sm, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(dev):
            raise_on(lib.decode_attention_prepare(inst, C, got_smem, per_sm,
                                                  n),
                     "decode_attention_fwd")
        if got_smem.value != smem:
            raise RuntimeError(f"decode_attention: the kernel takes "
                               f"{got_smem.value} bytes of shared memory, "
                               f"ops.smem_bytes says {smem}")
        _OCCUPANCY[key] = (per_sm.value, n.value)
    return _OCCUPANCY[key]


def card_plan(rows: int, G: int, W: int, D: int, kh: int,
              q_dtype: torch.dtype, kv_dtype: torch.dtype,
              dev: torch.device) -> Plan:
    """`plan` on the card ``dev``: its SMs, the CTAs an SM holds and the
    clusters it holds at once, from the occupancy calculator."""
    _check_dtypes(q_dtype, kv_dtype, D)
    lib = library()
    inst = instance(q_dtype, kv_dtype, D)
    smem = smem_bytes(q_dtype, kv_dtype, D)

    def occ(C):
        return _occupancy(lib, inst, dev, smem, C)

    p = plan(rows, G, W, D, kh, q_dtype, kv_dtype, sm_count(dev),
             lambda C: occ(C)[1], per_sm=max(1, occ(1)[0]))
    if p.resident < 1:
        raise RuntimeError(f"decode_attention: no cluster of {p.cluster} "
                           f"CTAs of {smem} bytes fits {dev}")
    return p


def _new_launch(key, dev: torch.device):
    rows, G, W, D, kh, valid_stride, q_dtype, kv_dtype, _index = key
    p = card_plan(rows, G, W, D, kh, q_dtype, kv_dtype, dev)
    args = _PlanArgs(p.instance, rows, G, W, D, kh, valid_stride, p.blocks,
                     p.cluster, p.head_blocks, D ** -0.5)
    return p, args, ctypes.addressof(args), library().decode_attention_run


def _launch(q, k, v, valid, valid_stride: int, kh: int, W: int, rows: int,
            G: int, out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: q (rows, G, D) contiguous; k and v rows of W
    keys, row r being kv head r % kh of batch r // kh in a (B, W, kh, D)
    buffer; valid row r at ``valid_stride * r``; the output into ``out``
    (q's shape and type)."""
    dev = q.device
    key = (rows, G, W, q.shape[-1], kh, valid_stride, q.dtype, k.dtype,
           dev.index)
    launch = _PLANS.get(key)
    if launch is None:
        launch = _PLANS[key] = _new_launch(key, dev)
    _p, _args, addr, run = launch
    raise_on(run(addr, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 valid.data_ptr(), out.data_ptr(), stream_of(dev)),
             "decode_attention_fwd")
    decode_attention_fwd.launches += 1
    return out


def _check_dtypes(q_dtype, kv_dtype, D: int) -> None:
    if q_dtype not in _DTYPES or kv_dtype not in KV_TYPES:
        raise TypeError(f"decode_attention takes q in {_DTYPES} and k, v "
                        f"of one type in {tuple(KV_TYPES)}; got {q_dtype}, "
                        f"{kv_dtype}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be at most {MAX_HEAD_DIM}, got {D}")


def _check_types(q, k, v) -> None:
    if v.dtype != k.dtype:
        raise TypeError(f"decode_attention takes q in {_DTYPES} and k, v "
                        f"of one type in {tuple(KV_TYPES)}; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    _check_dtypes(q.dtype, k.dtype, q.shape[-1])


def decode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """q (B·KH, G, D); k, v (B·KH, W, D); valid (B·KH, W) int32.  Returns
    (B·KH, G, D) in q's type."""
    rows, G, D = q.shape
    refuse_grad("decode_attention_fwd", DECODE_PLAIN, q, k, v)
    if (k.dim() != 3 or k.shape[0] != rows or k.shape[2] != D
            or v.shape != k.shape or tuple(valid.shape) != tuple(k.shape[:2])):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, valid {tuple(valid.shape)} "
                         f"do not fit")
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if not t.is_contiguous():        # on every device: the kernel's
            raise ValueError(f"{name} must be contiguous")   # layout
    if valid.dtype != torch.int32:
        raise TypeError(f"valid must be int32, got {valid.dtype}")
    if not bool((valid != 0).any(dim=1).all()):
        raise ValueError("decode_attention: a row has no valid slot")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_attention kernel for {q.device}")
    _check_types(q, k, v)
    W = k.shape[1]
    dev = q.device
    check_tensor("k", k, k.dtype, (rows, W, D), dev)
    check_tensor("v", v, k.dtype, (rows, W, D), dev)
    check_tensor("valid", valid, torch.int32, (rows, W), dev)
    return _launch(q, k, v, valid, W, 1, W, rows, G, torch.empty_like(q))


decode_attention_fwd.launches = 0


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    decode_attention_fwd.launches = 0


@functools.lru_cache(maxsize=16)
def _validity(W: int, index: int, window: int, device: torch.device
              ) -> torch.Tensor:
    """`ring_validity` on ``device``, made once per (W, index, window):
    every layer of a decode step with the same ring shares it."""
    return ring_validity(W, index, window, device=device)


def grouped_rows(q: torch.Tensor, KH: int) -> torch.Tensor:
    """(B, 1, H, D) -> contiguous (B·KH, G, D), G = H // KH: row b·KH + h
    holds the q heads h·G .. h·G + G - 1 of batch b.  A contiguous q
    already lies so: the kernel reads it in place."""
    B, _, H, D = q.shape
    return q.reshape(B * KH, H // KH, D).contiguous()


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     index: int, *, window: int = 0) -> torch.Tensor:
    """q (B, 1, H, D); ck, cv (B, W, KH, D) ring caches (k roped at
    write), ``index`` the absolute position of q's token.  Returns
    (B, 1, H, D) in q's type."""
    B, one, H, D = q.shape
    W, KH = ck.shape[1], ck.shape[2]
    refuse_grad("decode_attention", DECODE_PLAIN, q, ck, cv)
    if (one != 1 or H % KH or ck.shape[0] != B or ck.shape[3] != D
            or cv.shape != ck.shape):
        raise ValueError(f"q {tuple(q.shape)} does not fit caches "
                         f"{tuple(ck.shape)}, {tuple(cv.shape)}")
    index, window = int(index), int(window)
    if index < 0 or window < 0 or W < 1:
        raise ValueError(f"index {index}, window {window}, W {W}")
    if not (ck.is_contiguous() and cv.is_contiguous()):
        raise ValueError("ck and cv must be contiguous")
    dev = q.device
    ok = _validity(W, index, window, dev)
    if dev.type == "cuda":
        if ck.device != dev or cv.device != dev:
            raise ValueError(f"caches on {ck.device}, {cv.device}, "
                             f"expected {dev}")
        if cv.dtype != ck.dtype:        # q's and the cache's types: `plan`
            _check_types(q, ck, cv)
        qc = q if q.is_contiguous() else q.contiguous()
        return _launch(qc, ck, cv, ok, 0, KH, W, B * KH, H // KH,
                       torch.empty_like(qc))
    if dev.type != "cpu":
        raise ValueError(f"no decode_attention kernel for {dev}")
    qg = grouped_rows(q, KH)
    kf = ck.transpose(1, 2).reshape(B * KH, W, D)
    vf = cv.transpose(1, 2).reshape(B * KH, W, D)
    o = decode_attention_ref(qg, kf, vf, ok[None].expand(B * KH, W))
    return o.view(B, 1, H, D)
