"""Flash attention's bfloat16 kernel at the LM path's shapes, to compare
two trees of the port in one call.

    python3 time_flash.py [--src DIR] [--reps N]

A harness beside `chip_smoke.py`, outside the port's package: it times
`scaled_dot_product_attention` as the yardstick, which the port never
calls.  Imports `repro_torch` from ``--src`` (default: this checkout's
``src``), so that one file times another checkout's kernel; run it on
each tree in turns (A, B, B, A) within one call.  The shapes are those of
`chip_smoke.py` (`FLASH_SHAPES` and `FAMILY_FLASH_SHAPES`), in
bfloat16, with inputs from a seeded generator on the card.  For each
shape: the kernel against the tree's plain version (2^-7 relative and
absolute, as the card tests), then the kernel's mean time over ``--reps``
launches after a warm-up one (CUDA events; ``ms_queued`` with the
launches queued behind a device sleep, so that the device's time is read
where the host's launch rate would set it), the time of
`scaled_dot_product_attention` on the same inputs (both ways), the bound
(`chip_smoke.flash_work` and `bound_of` at the bf16 rate) and the
kernel's share of it.  Prints the library's ptxas report, one JSON line
per shape and a last line with the card's name and power limit
(``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("time_flash times the card: no CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    dev = torch.device("cuda", 0)
    _path, log = fa_ops.LIBRARY.build()
    print(json.dumps({"time_flash_build": {
        "src": src, "instances": cs.ptxas_instances(log)}}), flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=dev).manual_seed(5)
    failed = []
    for shape in cs.FLASH_SHAPES + cs.FAMILY_FLASH_SHAPES:
        name, B, Sq, Sk, H, KH, D, mask, window = shape
        q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                   for s in ((B * H, Sq, D), (B * KH, Sk, D),
                             (B * KH, Sk, D)))
        kw = dict(mask_kind=mask, window=window, group=H // KH)
        with torch.no_grad():
            got = fa_ops.flash_attention_fwd(q, k, v, **kw)
            want = fa_ref.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), rtol=2.0 ** -7,
                                atol=2.0 ** -7)
            del got, want
            qq, kk, vv = (t.view(B, t.shape[0] // B, t.shape[1], D)
                          for t in (q, k, v))
            live = (None if mask != "window"
                    else fa_ref.index_mask(mask, Sq, Sk, window, dev))

            def kernel():
                return fa_ops.flash_attention_fwd(q, k, v, **kw)

            def library():
                return sdpa(qq, kk, vv, attn_mask=live,
                            is_causal=mask == "causal", enable_gqa=True)

            ms, ms_queued, library_ms, library_ms_queued = (
                cs.cuda_ms(fn, [()] * args.reps, torch, warm_up=True,
                           ahead=ahead)
                for fn in (kernel, library) for ahead in (False, True))
        nbytes, flops = cs.flash_work(B, Sq, Sk, H, KH, D, mask, window, 2)
        bound_ms, bound_by = cs.bound_of(nbytes, flops, cs.BF16_FLOPS)
        print(json.dumps({"time_flash": dict(
            src=src, shape=name, ok=ok, max_abs_err=err, ms=ms,
            ms_queued=ms_queued, library_ms=library_ms,
            library_ms_queued=library_ms_queued, bound_ms=bound_ms,
            bound_by=bound_by,
            bound_share=bound_ms / ms, tflops=flops / ms * 1e-9)}),
            flush=True)
        del q, k, v, qq, kk, vv
        if not ok:
            failed.append(name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if failed:
        print(f"time_flash: disagrees with the plain version at {failed}",
              file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
