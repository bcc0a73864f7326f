"""Wrappers around the CUDA SSD scan kernel (`csrc/ssd_scan.cu`).

* `ssd_scan_fwd(x, dt, A, B_, C_, *, heads, chunk)` takes the Pallas
  function's layout: x (B·H, S, P), dt (B·H, S) float32 (softplus
  applied), A (B·H, 1) float32, and B_, C_ (B, S, N) shared by the
  ``heads`` heads of each batch row (row b reads batch b // heads; they
  are never copied per head).
* `ssd_scan(xs, dt, A, B_, C_, chunk)` is the model layer's entry, with
  the reference wrapper's signature: xs (B, S, H, P), dt (B, S, H), A
  (H,), B_, C_ (B, S, N).  It returns y (B, S, H, P) and the final state
  (B, H, P, N), both float32.

x, B_ and C_ share one type, float32 or bfloat16.  On a CUDA tensor the
hand-written kernels run, built at first use with ``nvcc`` into
``build/kernels/`` of the checkout and bound with `ctypes`: one call
launches `KERNELS_PER_CALL` kernels (C·Bᵀ per batch row and chunk, each
chunk's local state, the pass over the chunks' start states, and y; see
`csrc/ssd_scan.cu`), with float32 scratch from the wrapper.  On a CPU
tensor the chunked plain version in `ref.py` runs.  There is no
fallback: a CUDA tensor gets the kernels or an exception.  Only a call
that launches the kernels adds one to ``ssd_scan_fwd.launches`` (one per
call, however many kernels it launches).

The kernel has no backward, as the reference's ``pallas_call`` has
none: with grad enabled and an input that requires it, every entry
raises on every device (`_build.refuse_grad`) rather than drop the
gradient; the model's differentiable path is its plain one.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from .._build import Library, check_tensor, raise_on, refuse_grad, stream_of
from .ref import ssd_chunked_ref

# the differentiable path the model takes under autograd
SSD_PLAIN = "impl='jnp' (the chunked plain scan, ref.ssd_chunked_ref)"

_DTYPES = (torch.float32, torch.bfloat16)
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256   # the kernel's padded tiles
KERNELS_PER_CALL = 4                     # CB, chunk state, pass, y
KERNEL_NAMES = ("ssd_cb_kernel", "ssd_state_kernel", "ssd_pass_kernel",
                "ssd_out_kernel")


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd_launch.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I,
                                        I, I, I, I, I, P]
    lib.ssd_scan_fwd_launch.restype = I
    lib.ssd_scan_occupancy.argtypes = [I, I, P, P]
    lib.ssd_scan_occupancy.restype = I


LIBRARY = Library(Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu",
                  _declare)


def library() -> ctypes.CDLL:
    """The kernel's shared library, built if needed and loaded once per
    process."""
    return LIBRARY.load()


def occupancy(bf16: bool) -> Dict[str, Tuple[int, int]]:
    """{kernel name: (dynamic shared memory bytes, CTAs per SM)} of the
    kernels one call launches, for bfloat16 or float32 inputs, on the
    current device (the CUDA occupancy calculator)."""
    lib = library()
    out = {}
    for which, name in enumerate(KERNEL_NAMES):
        smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
        raise_on(lib.ssd_scan_occupancy(which, int(bf16), ctypes.byref(smem),
                                        ctypes.byref(blocks)),
                 "ssd_scan_occupancy")
        out[name] = (smem.value, blocks.value)
    return out


def scratch_shapes(BH: int, Bb: int, S: int, P: int, N: int, Q: int
                   ) -> Tuple[Tuple[int, ...], ...]:
    """Shapes of the scratch one call needs: C·Bᵀ tiles (Bb, nc, Qp, Qp)
    float32, the chunks' cumulative decays (BH, nc, Qp) float64 and their
    states (BH, nc, P, N) float32, with nc = ceil(S / Q) chunks and Qp = Q
    rounded up to the kernels' 64-row tiles."""
    nc = -(-S // Q) if S else 0
    Qp = -(-max(Q, 1) // 64) * 64
    return (Bb, nc, Qp, Qp), (BH, nc, Qp), (BH, nc, P, N)


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
    y = torch.empty((BH, S, P), dtype=torch.float32, device=dev)
    state = torch.empty((BH, P, N), dtype=torch.float32, device=dev)
    if BH == 0:
        return y, state
    cb, cum, states = (torch.empty(shape, dtype=dtype, device=dev)
                       for shape, dtype in zip(
                           scratch_shapes(BH, Bb, S, P, N, Q),
                           (torch.float32, torch.float64, torch.float32)))
    err = library().ssd_scan_fwd_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
        C_.data_ptr(), y.data_ptr(), state.data_ptr(), cb.data_ptr(),
        cum.data_ptr(), states.data_ptr(), BH, S, P, N, Q, heads,
        int(x.dtype == torch.bfloat16), stream_of(dev))
    raise_on(err, "ssd_scan_fwd")
    ssd_scan_fwd.launches += 1
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
