"""Dry run of the production meshes on the host (port of
`repro.launch.dryrun`): trace one step of every (architecture x input
shape x mesh) cell on a ``fake`` process group of 256 or 512 ranks with
DTensors whose local shards live on the ``meta`` device — sharded
parameters, optimizer state, inputs and every intermediate have shapes
and dtypes and no storage, nothing is allocated — and count it per rank
with `launch.op_cost`: argument bytes (the local shards), the peak
of live bytes, flops, bytes, collective bytes by kind, the card's
roofline terms, `model_flops` and the useful-flop ratio.

Usage (the reference's flags, same skips, same JSONL records):
  python -m repro_torch.launch.dryrun --arch internlm2-20b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
  python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod \\
      --override q_block=4096 --override remat=full --seq-shard

This process is rank 0 of the fake group (`FakeStore`): collectives
return at once, so the counts are one rank's.  A record's ``lower_s`` and
``compile_s`` have no counterpart (nothing is lowered or compiled); its
``trace_s`` is the seconds of the traced step, and ``counted_by`` says
how the figures were taken.  The step is the card's program without its
kernels: on `meta` shards attention takes its plain paths
(`layers.on_meta`) and the scans run ``impl="jnp"``; the train step
differentiates them as on one card.  Eager bytes are unfused
(`op_cost`), so they read above XLA's fusion-aware count.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs import all_archs, get_config
from ..distributed.sharding import (NamedSharding, base_rules,
                                    decode_rules, sharding_context,
                                    tree_shardings, validate_divisibility,
                                    zip_axes)
from . import op_cost, roofline
from .mesh import make_production_mesh
from .specs import (PERF_OVERRIDES, SHAPES, batch_axes, cell_supported,
                    input_specs, shape_overrides)

COUNTED_BY = ("launch.op_cost: eager aten ops on this rank's shards, "
              "unfused; lower_s and compile_s have no counterpart, "
              "trace_s is the traced step's seconds")


def _coerce(cfg, key: str, val: str):
    cur = getattr(cfg, key)
    if isinstance(cur, bool):
        return val.lower() in ("1", "true", "yes")
    if isinstance(cur, int):
        return int(val)
    if isinstance(cur, float):
        return float(val)
    return val


def _parse_rule(v: str):
    if v.lower() in ("none", "null"):
        return None
    if "," in v:
        return tuple(v.split(","))
    return v


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def build_cell(arch: str, shape: str, *, multi_pod: bool,
               overrides: Optional[Dict[str, str]] = None,
               rules_overrides: Optional[Dict[str, str]] = None,
               seq_shard: bool = False, mesh=None, config=get_config):
    """(config after the shape's and the caller's overrides, the shape's
    info, the mesh — the production one unless given — and the rules)."""
    cfg = shape_overrides(config(arch), shape)
    if overrides:
        cfg = dataclasses.replace(
            cfg, **{k: _coerce(cfg, k, v) for k, v in overrides.items()})
    info = SHAPES[shape]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    if info["kind"] == "decode":
        rules = decode_rules(multi_pod, long_context=info.get("long", False))
    else:
        rules = base_rules(multi_pod, seq_shard=seq_shard)
    if rules_overrides:
        rules.update({k: _parse_rule(v) for k, v in rules_overrides.items()})
    return cfg, info, mesh, rules


def _contiguous_stride(shape):
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def meta_tree(specs, shardings, dtype: Optional[torch.dtype] = None):
    """DTensors of ``meta`` local shards for a tree of stand-ins and their
    `NamedSharding`s (``dtype`` in place of each leaf's, when given)."""
    from torch.distributed.tensor import DTensor

    def leaf(t, s: NamedSharding):
        shape = tuple(t.shape)
        local = torch.empty(s.shard_shape(shape), dtype=dtype or t.dtype,
                            device="meta")
        return DTensor.from_local(local, s.mesh, s.placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))
    if isinstance(specs, dict):
        return {k: meta_tree(v, shardings[k], dtype) for k, v in
                specs.items()}
    if isinstance(specs, (tuple, list)):
        return type(specs)(meta_tree(t, s, dtype)
                           for t, s in zip(specs, shardings))
    return leaf(specs, shardings)


def local_bytes(specs, axes, mesh, rules, dtype=None) -> int:
    """Bytes of this rank's shards of a tree of stand-ins."""
    total = 0
    for t, (s, _a) in zip(
            (t for t, _a in zip_axes(specs, axes)),
            zip_axes(tree_shardings(axes, mesh, rules), axes)):
        n = 1
        for d in s.shard_shape(tuple(t.shape)):
            n *= d
        total += n * (dtype or t.dtype).itemsize
    return total


def _out_bytes(out) -> int:
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten
    total = 0
    for t in tree_flatten(out)[0]:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _trace(cfg, info, mesh, rules, shape: str) -> Dict[str, Any]:
    """One step of ``cfg`` on the cell's fake shards, counted: the
    `OpCost` result, the argument and output bytes, the trace's seconds."""
    from ..launch.steps import (make_decode_step, make_prefill_step,
                                make_train_step)
    from ..models import cache_axes, param_axes, param_shapes
    from ..optim import AdamWState
    p_axes = param_axes(cfg)
    p_shapes = param_shapes(cfg)
    p_shard = tree_shardings(p_axes, mesh, rules)
    specs = input_specs(cfg, shape)
    b_axes = batch_axes(cfg, shape)
    arg_bytes = _trace_args_bytes(cfg, info, mesh, rules, shape)
    params = meta_tree(p_shapes, p_shard)
    if info["kind"] == "train":
        step = make_train_step(cfg)
        opt = AdamWState(step=torch.zeros((), dtype=torch.int32,
                                          device="meta"),
                         m=meta_tree(p_shapes, p_shard, torch.float32),
                         v=meta_tree(p_shapes, p_shard, torch.float32))
        batch = meta_tree(specs["batch"], tree_shardings(
            b_axes["batch"], mesh, rules))
        args = (params, opt, batch)
    elif info["kind"] == "prefill":
        step = make_prefill_step(cfg, max_seq=info["seq"], impl="jnp")
        batch = meta_tree(specs["batch"], tree_shardings(
            b_axes["batch"], mesh, rules))
        args = (params, batch)
    else:
        step = make_decode_step(cfg)
        c_axes = cache_axes(cfg, info["batch"], info["seq"])
        cache = meta_tree(specs["cache"], tree_shardings(c_axes, mesh,
                                                         rules))
        # a full cache: the next token's position is the last one
        cache["index"] = info["seq"] - 1
        tokens = meta_tree(specs["tokens"], tree_shardings(
            b_axes["tokens"], mesh, rules))
        args = (params, tokens, cache)
    t0 = time.perf_counter()
    with sharding_context(mesh, rules), \
            op_cost.OpCost(baseline=arg_bytes, device="meta") as cost:
        out = step(*args)
    seconds = time.perf_counter() - t0
    res = cost.result()
    res.update(argument_bytes=arg_bytes, output_bytes=_out_bytes(out),
               trace_s=seconds)
    return res


_ADDITIVE = ("flops", "dot_flops", "bytes", "coll_bytes", "ops",
             "output_bytes")


def _extrapolate(one: Dict[str, Any], two: Dict[str, Any], n: int,
                 arg_bytes: int) -> Dict[str, Any]:
    """A depth of ``n`` cycles from traces of 1 and 2: every count grows
    by the second cycle's increment per cycle (each cycle runs the same
    ops on the same shapes); the peak is ``arg_bytes`` plus the transient
    bytes (peak less arguments) extrapolated likewise."""
    def lin(a, b):
        return a + (n - 1) * (b - a)
    out = {k: lin(one[k], two[k]) for k in _ADDITIVE}
    for key in ("coll_by_kind", "coll_counts"):
        kinds = set(one[key]) | set(two[key])
        out[key] = {k: lin(one[key].get(k, 0), two[key].get(k, 0))
                    for k in sorted(kinds)}
    t1 = one["peak_live_bytes"] - one["argument_bytes"]
    t2 = two["peak_live_bytes"] - two["argument_bytes"]
    out.update(argument_bytes=arg_bytes, unparsed_loops=0,
               peak_live_bytes=arg_bytes + lin(t1, t2),
               trace_s=one["trace_s"] + two["trace_s"])
    return out


def lower_cell(arch: str, shape: str, *, multi_pod: bool = False,
               overrides: Optional[Dict[str, str]] = None,
               rules_overrides: Optional[Dict[str, str]] = None,
               seq_shard: bool = False, verbose: bool = True, mesh=None,
               config=get_config) -> Dict[str, Any]:
    """Trace and count one step of the cell; returns its record.  A model
    of more than 2 cycles of its layer pattern is traced at 1 and 2 cycles
    (its tail and encoder kept) and extrapolated to its depth
    (`_extrapolate`); its argument bytes are its own, from the shapes.
    ``mesh`` (default: the production mesh over the fake group) and
    ``config`` (default: `configs.get_config`) let a test run a small
    cell."""
    from ..models import param_axes, param_shapes
    cfg, info, mesh, rules = build_cell(
        arch, shape, multi_pod=multi_pod, overrides=overrides,
        rules_overrides=rules_overrides, seq_shard=seq_shard, mesh=mesh,
        config=config)
    chips = mesh.size()
    validate_divisibility(param_shapes(cfg), param_axes(cfg), mesh, rules)
    n_cycles, tail = cfg.cycles_and_tail
    if n_cycles > 2:
        depth = [dataclasses.replace(
            cfg, num_layers=k * len(cfg.pattern) + tail) for k in (1, 2)]
        one, two = (_trace(c, info, mesh, rules, shape) for c in depth)
        parsed = _extrapolate(one, two, n_cycles, _trace_args_bytes(
            cfg, info, mesh, rules, shape))
        traced = [1, 2]
    else:
        parsed = _trace(cfg, info, mesh, rules, shape)
        traced = [n_cycles]
    arg_bytes = parsed["argument_bytes"]
    t_trace = parsed["trace_s"]

    flops_chip = float(parsed["flops"])
    bytes_chip = float(parsed["bytes"])
    coll = {"total": parsed["coll_bytes"],
            "per_kind": parsed["coll_by_kind"],
            "counts": parsed["coll_counts"]}
    terms = roofline.terms(flops_chip, bytes_chip, float(coll["total"]))
    mflops = roofline.model_flops(cfg, info)
    flops_global = flops_chip * chips
    peak = parsed["peak_live_bytes"]
    rec = {
        "arch": arch, "shape": shape,
        "mesh": mesh_name(multi_pod), "chips": chips,
        "status": "ok",
        "lower_s": None, "compile_s": None, "trace_s": round(t_trace, 2),
        "counted_by": COUNTED_BY,
        "depth": {"cycles": n_cycles, "traced_cycles": traced,
                  "extrapolated": n_cycles > 2},
        "flops_per_chip": flops_chip, "bytes_per_chip": bytes_chip,
        "dot_flops_per_chip": float(parsed["dot_flops"]),
        "collective_bytes_per_chip": coll["total"],
        "collective_detail": coll,
        "xla_cost_analysis": None,
        "unparsed_loops": parsed["unparsed_loops"],
        "ops": parsed["ops"],
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": parsed["output_bytes"],
            "temp_bytes": peak - arg_bytes,
            "peak_bytes": peak,
            "alias_bytes": None,
            "code_bytes": None,
        },
        "terms": terms,
        "model_flops_global": mflops,
        "hlo_flops_global": flops_global,
        "useful_flop_ratio": (mflops / flops_global if flops_global
                              else 0.0),
        "overrides": {**(overrides or {}),
                      **{f"rule:{k}": str(v)
                         for k, v in (rules_overrides or {}).items()}},
        "seq_shard": seq_shard,
    }
    if verbose:
        print(f"[{arch} x {shape} x {rec['mesh']}] trace {t_trace:.1f}s "
              f"(cycles traced {traced} of {n_cycles})")
        print(f"  memory/chip: args {arg_bytes / 2**30:.2f} GiB"
              f" peak {peak / 2**30:.2f} GiB of 80 GB HBM")
        print(f"  flops/chip {flops_chip:.3e}  bytes/chip {bytes_chip:.3e}"
              f"  coll bytes/chip {coll['total']:.3e} {coll['counts']}")
        print(f"  terms: compute {terms['compute_s'] * 1e3:.2f} ms | memory "
              f"{terms['memory_s'] * 1e3:.2f} ms | collective "
              f"{terms['collective_s'] * 1e3:.2f} ms -> dominant "
              f"{terms['dominant']} (roofline frac "
              f"{terms['roofline_fraction'] * 100:.1f}%)")
        print(f"  MODEL_FLOPS/OP_FLOPS = {rec['useful_flop_ratio']:.3f}")
    return rec


def _trace_args_bytes(cfg, info, mesh, rules, shape: str) -> int:
    """The cell's argument bytes on this rank, from the shapes alone."""
    from ..models import cache_axes, param_axes, param_shapes
    p_axes, p_shapes = param_axes(cfg), param_shapes(cfg)
    specs, b_axes = input_specs(cfg, shape), batch_axes(cfg, shape)
    n = local_bytes(p_shapes, p_axes, mesh, rules)
    if info["kind"] == "train":
        n += 4 + 2 * local_bytes(p_shapes, p_axes, mesh, rules,
                                 torch.float32)
    if info["kind"] in ("train", "prefill"):
        return n + local_bytes(specs["batch"], b_axes["batch"], mesh, rules)
    c_axes = cache_axes(cfg, info["batch"], info["seq"])
    return (n + local_bytes(specs["cache"], c_axes, mesh, rules)
            + local_bytes(specs["tokens"], b_axes["tokens"], mesh, rules))


def fake_world(world: int):
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks (host only: collectives return at once); replaces a fake group
    of another size, refuses to replace any other."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a dry run needs this process's default "
                               "group for its fake world")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def main(argv=None):
    import torch.distributed as dist
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--perf", action="store_true",
                    help="apply the adopted performance overrides per cell")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override key=value (repeatable)")
    ap.add_argument("--rule", action="append", default=[],
                    help="sharding-rule override key=value (value: mesh "
                         "axis name, comma-tuple, or 'none')")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.override)
    rules_overrides = dict(kv.split("=", 1) for kv in args.rule)

    if args.all:
        cells = [(a, s, mp) for a in all_archs() for s in SHAPES
                 for mp in ((False, True) if args.both_meshes else (False,))]
    else:
        meshes = (False, True) if args.both_meshes else (args.multi_pod,)
        cells = [(args.arch, args.shape, mp) for mp in meshes]

    done = set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("status") == "ok" and not r.get("overrides"):
                    done.add((r["arch"], r["shape"], r["mesh"]))

    failures = 0
    records = []
    own_group = not dist.is_initialized()
    try:
        for arch, shape, mp in cells:
            name = mesh_name(mp)
            ok, why = cell_supported(arch, shape)
            if not ok:
                rec = {"arch": arch, "shape": shape, "mesh": name,
                       "status": "skipped", "reason": why}
                print(f"[{arch} x {shape} x {name}] SKIP: {why}")
            elif (arch, shape, name) in done and not overrides:
                print(f"[{arch} x {shape} x {name}] cached, skipping")
                continue
            else:
                try:
                    fake_world(512 if mp else 256)
                    cell_over = dict(overrides)
                    if args.perf:
                        cell_over.update(PERF_OVERRIDES.get(
                            (arch.replace("-", "_").replace(".", "_"),
                             shape), {}))
                    rec = lower_cell(arch, shape, multi_pod=mp,
                                     overrides=cell_over,
                                     rules_overrides=rules_overrides,
                                     seq_shard=args.seq_shard)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": name,
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
            records.append(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")
    return records


if __name__ == "__main__":
    main()
