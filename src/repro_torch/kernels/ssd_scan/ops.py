"""Wrappers around the CUDA SSD scan kernels (`csrc/ssd_scan.cu`).

* `ssd_scan_fwd(x, dt, A, B_, C_, *, heads, chunk)` takes the Pallas
  function's layout: x (B·H, S, P), dt (B·H, S) float32 (softplus
  applied), A (B·H, 1) float32, and B_, C_ (B, S, N) shared by the
  ``heads`` heads of each batch row (row b reads batch b // heads; they
  are never copied per head).
* `ssd_scan(xs, dt, A, B_, C_, chunk)` is the model layer's entry, with
  the reference wrapper's signature: xs (B, S, H, P), dt (B, S, H), A
  (H,), B_, C_ (B, S, N).  It returns y (B, S, H, P) and the final state
  (B, H, P, N), both float32.

x, B_ and C_ share one type, bfloat16 or float32.  On a CUDA tensor the
hand-written kernels run, built at first use with ``nvcc`` into
``build/kernels/`` of the checkout and bound with `ctypes`, with scratch
from the wrapper (`scratch_shapes`); one call launches the kernels of
`KERNEL_NAMES` for its type (see `csrc/ssd_scan.cu`):

* bfloat16, the model's type: one persistent kernel on `wgmma` fed by
  TMA (`ssd_wg_scan_kernel`) that computes each chunk's end state, chains
  the start states from chunk to chunk and computes y.  The TMA unit needs
  rows of a multiple of 16 bytes, so P and N are zero-padded to multiples
  of 8 (`pad8`: zero columns add nothing to C·Bᵀ or to the state) and y
  and the state are sliced back;
* float32: four split-TF32 kernels (C·Bᵀ, the local states, the pass over
  the start states, y).

On a CPU tensor the chunked plain version in `ref.py` runs.  There is no
fallback: a CUDA tensor gets the kernels or an exception (a refused
launch, a tensor map that cannot be encoded, a failed build).  Only a
call that launches the kernels adds one to ``ssd_scan_fwd.launches``
(one per call, however many kernels it launches and whether or not it
padded).

The kernels have no backward, as the reference's ``pallas_call`` has
none: with grad enabled and an input that requires it, every entry
raises on every device (`_build.refuse_grad`) rather than drop the
gradient; the model's differentiable path is its plain one.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .._build import Library, check_tensor, raise_on, refuse_grad, stream_of
from .ref import ssd_chunked_ref

# the differentiable path the model takes under autograd
SSD_PLAIN = "impl='jnp' (the chunked plain scan, ref.ssd_chunked_ref)"

_DTYPES = (torch.float32, torch.bfloat16)
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256   # the kernels' padded tiles
TILE = 64                                # rows of a t or s tile
KERNEL_NAMES = {
    torch.bfloat16: ("ssd_wg_scan_kernel",),
    torch.float32: ("ssd_cb_kernel", "ssd_state_kernel", "ssd_pass_kernel",
                    "ssd_out_kernel"),
}
KERNELS_PER_CALL = {dtype: len(names) for dtype, names in
                    KERNEL_NAMES.items()}
# the CTAs per SM each kernel is designed to run at: the persistent
# bfloat16 kernel one (all of an SM's shared memory), the float32 kernels
# at least two
CTAS_PER_SM = {"ssd_wg_scan_kernel": 1,
               "ssd_cb_kernel": 2, "ssd_state_kernel": 2,
               "ssd_pass_kernel": 2, "ssd_out_kernel": 2}


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_f32_launch.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I,
                                        I, I, I, I, P]
    lib.ssd_scan_f32_launch.restype = I
    lib.ssd_scan_bf16_launch.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I,
                                         I, I, I, P]
    lib.ssd_scan_bf16_launch.restype = I
    lib.ssd_scan_occupancy.argtypes = [I, I, P, P]
    lib.ssd_scan_occupancy.restype = I


LIBRARY = Library(Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu",
                  _declare)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed and loaded once per
    process."""
    return LIBRARY.load()


def occupancy(bf16: bool) -> Dict[str, Tuple[int, int]]:
    """{kernel name: (dynamic shared memory bytes, CTAs per SM)} of the
    kernels one call launches, for bfloat16 or float32 inputs, on the
    current device (the CUDA occupancy calculator)."""
    lib = library()
    out = {}
    names = KERNEL_NAMES[torch.bfloat16 if bf16 else torch.float32]
    for which, name in enumerate(names):
        smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
        raise_on(lib.ssd_scan_occupancy(which, int(bf16), ctypes.byref(smem),
                                        ctypes.byref(blocks)),
                 "ssd_scan_occupancy")
        out[name] = (smem.value, blocks.value)
    return out


def round8(n: int) -> int:
    """n rounded up to a multiple of 8."""
    return -(-n // 8) * 8


def scratch_shapes(BH: int, Bb: int, S: int, P: int, N: int, Q: int,
                   dtype: torch.dtype = torch.bfloat16
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of the scratch one call needs, with nc =
    ceil(S / Q) chunks and Qp = Q rounded up to the kernels' 64-row tiles.
    bfloat16: the chunks' start states (B·H, nc, 64, 128) float32 (zero
    past P and N), and int32 the ticket that hands out the (row, chunk)
    units followed by a publication count per (row, chunk).  float32: C·Bᵀ tiles (Bb, nc, Qp, Qp)
    float32, the cumulative decays (B·H, nc, Qp) float64 and the states
    (B·H, nc, P, N) float32."""
    nc = -(-S // Q) if S else 0
    Qp = -(-max(Q, 1) // TILE) * TILE
    if dtype == torch.bfloat16:
        return {"states": ((BH, nc, MAX_P, MAX_N), torch.float32),
                "sync": ((1 + BH * nc,), torch.int32)}
    return {"cb": ((Bb, nc, Qp, Qp), torch.float32),
            "cum": ((BH, nc, Qp), torch.float64),
            "states": ((BH, nc, P, N), torch.float32)}


def pad8(x: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x with its last dim P, and B_, C_ with theirs N, zero-padded to
    multiples of 8 (each returned as it is where it already is one)."""
    P, N = x.shape[-1], B_.shape[-1]
    if P % 8:
        x = F.pad(x, (0, round8(P) - P))
    if N % 8:
        B_, C_ = (F.pad(t, (0, round8(N) - N)) for t in (B_, C_))
    return x, B_, C_


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where it starts on a 16-byte boundary (as a TMA map
    needs), else a fresh copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B_: torch.Tensor, C_: torch.Tensor, *, heads: int,
                 chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B·H, S, P); dt (B·H, S) float32; A (B·H, 1) float32; B_, C_
    (B, S, N) of x's type, H = ``heads``.  Returns (y (B·H, S, P)
    float32, final state (B·H, P, N) float32)."""
    BH, S, P = x.shape
    Bb, Sb, N = B_.shape
    if (heads < 1 or BH != Bb * heads or Sb != S or C_.shape != B_.shape
            or tuple(dt.shape) != (BH, S) or A.numel() != BH):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B_ {tuple(B_.shape)}, "
                         f"C_ {tuple(C_.shape)} do not fit heads {heads}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    refuse_grad("ssd_scan_fwd", SSD_PLAIN, x, dt, A, B_, C_)
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B_", B_), ("C_", C_)):
        if not t.is_contiguous():        # on every device: the kernel's
            raise ValueError(f"{name} must be contiguous")   # layout
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, B_, C_, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan kernel for {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan takes {_DTYPES}, got {x.dtype}")
    Q = min(chunk, S)
    if P > MAX_P or N > MAX_N or Q > MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel takes P <= {MAX_P}, N <= "
                         f"{MAX_N} and chunk <= {MAX_CHUNK}; got P {P}, "
                         f"N {N}, chunk {Q}")
    dev = x.device
    check_tensor("x", x, x.dtype, (BH, S, P), dev)
    check_tensor("dt", dt, torch.float32, (BH, S), dev)
    check_tensor("A", A, torch.float32, tuple(A.shape), dev)
    check_tensor("B_", B_, x.dtype, (Bb, S, N), dev)
    check_tensor("C_", C_, x.dtype, (Bb, S, N), dev)
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        x, B_, C_ = (_aligned(t) for t in pad8(x, B_, C_))
    Pk, Nk = x.shape[-1], B_.shape[-1]
    y = torch.empty((BH, S, Pk), dtype=torch.float32, device=dev)
    state = torch.empty((BH, Pk, Nk), dtype=torch.float32, device=dev)
    if BH == 0:
        return y[..., :P], state[:, :P, :N]
    scratch = [torch.empty(shape, dtype=dtype, device=dev) for shape, dtype
               in scratch_shapes(BH, Bb, S, Pk, Nk, Q, x.dtype).values()]
    launch = (library().ssd_scan_bf16_launch if bf16
              else library().ssd_scan_f32_launch)
    err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
                 C_.data_ptr(), y.data_ptr(), state.data_ptr(),
                 *(t.data_ptr() for t in scratch), BH, S, Pk, Nk, Q, heads,
                 stream_of(dev))
    raise_on(err, "ssd_scan_fwd")
    ssd_scan_fwd.launches += 1
    if (Pk, Nk) != (P, N):
        return y[..., :P].contiguous(), state[:, :P, :N].contiguous()
    return y, state


ssd_scan_fwd.launches = 0


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    ssd_scan_fwd.launches = 0


def kernel_layout(xs: torch.Tensor, dt: torch.Tensor, A: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S, H, P), (B, S, H), (H,) -> the kernel's contiguous x (B·H, S,
    P), dt (B·H, S) float32 and A (B·H, 1) float32, row b·H + h holding
    head h of batch b."""
    Bb, S, H, P = xs.shape
    x = xs.transpose(1, 2).contiguous().view(Bb * H, S, P)
    d = dt.float().transpose(1, 2).contiguous().view(Bb * H, S)
    a = A.float()[None].expand(Bb, H).reshape(Bb * H, 1).contiguous()
    return x, d, a


def ssd_scan(xs: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs (B, S, H, P); dt (B, S, H) float32; A (H,) float32; B_, C_
    (B, S, N).  Returns (y (B, S, H, P) float32, final state (B, H, P, N)
    float32)."""
    Bb, S, H, P = xs.shape
    x, d, a = kernel_layout(xs, dt, A)
    y, state = ssd_scan_fwd(x, d, a, B_.to(xs.dtype).contiguous(),
                            C_.to(xs.dtype).contiguous(), heads=H,
                            chunk=chunk)
    return (y.view(Bb, H, S, P).transpose(1, 2),
            state.view(Bb, H, P, state.shape[-1]))
