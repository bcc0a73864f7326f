"""Package guards for the port: it stands alone (no jax, no `repro`)."""
import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of `repro_torch`, imported in a fresh interpreter,
    leaves `jax` and `repro` out of `sys.modules`."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not leaked, leaked
        print(" ".join(names))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    assert len(walked) >= 45                  # the whole package was walked
    assert {"repro_torch.kernels._build", "repro_torch.kernels.cckp_dp.ops",
            "repro_torch.core.amdp", "repro_torch.api.front",
            "repro_torch.api.solvers", "repro_torch.serving.fleet",
            "repro_torch.convert",
            # the dense LM and the serving runtime
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.flash_attention.ref",
            "repro_torch.models.config", "repro_torch.models.layers",
            "repro_torch.models.model", "repro_torch.configs.paper_edge",
            "repro_torch.configs.gemma3_1b", "repro_torch.data.pipeline",
            "repro_torch.serving.executor", "repro_torch.serving.runtime",
            "repro_torch.launch.serve",
            # generation: the SSD scan, flash-decode, mamba2
            "repro_torch.kernels.ssd_scan.ops",
            "repro_torch.kernels.ssd_scan.ref",
            "repro_torch.kernels.decode_attention.ops",
            "repro_torch.kernels.decode_attention.ref",
            "repro_torch.configs.mamba2_130m",
            # the dual scheduler, the serving engine_v2 name, the shims
            "repro_torch.core.dual", "repro_torch.serving.engine_v2",
            "repro_torch.serving.planner",
            # the chaos and mobility scenarios
            "repro_torch.core.faults", "repro_torch.core.mobility",
            "repro_torch.serving.faults",
            # training
            "repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.optim.adafactor", "repro_torch.launch.steps",
            "repro_torch.launch.train", "repro_torch.checkpoint.manager",
            "repro_torch.distributed.compression",
            "repro_torch.examples.train_lm"} <= walked


def _import_roots(script):
    """The top-level packages a script of the repo root names in its
    import statements."""
    import ast
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    """`chip_smoke.py` (run on a card machine without jax) names no `jax`
    or `repro` module in any import statement."""
    roots = _import_roots("chip_smoke.py")
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)


def test_time_kernels_imports_neither_jax_nor_the_reference():
    """`time_kernels.py`, the card's two-trees timing harness, names no
    `jax` or `repro` module either."""
    roots = _import_roots("time_kernels.py")
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)


def test_build_helper_names_libraries_by_content(tmp_path, monkeypatch):
    """Without a CUDA compiler the build raises (there is no fallback);
    the library name follows the source and its flags."""
    from repro_torch.kernels import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    src = tmp_path / "k.cu"
    src.write_text("// kernel")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(src)
    assert not list((tmp_path / "kernels").glob("*.so"))


def test_port_calls_no_library_attention_or_compiler():
    """No module of `repro_torch` calls `scaled_dot_product_attention` or
    `torch.compile`, or imports a `flash_attn` package: attention on the
    card is the port's own kernels (the smoke script may time SDPA beside
    them; the port never calls it)."""
    import ast
    root = os.path.join(REPO, "src", "repro_torch")
    found = []
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                where = f"{os.path.relpath(path, REPO)}:{node.lineno}" \
                    if hasattr(node, "lineno") else path
                if isinstance(node, ast.Attribute):
                    if node.attr == "scaled_dot_product_attention" or (
                            node.attr == "compile"
                            and isinstance(node.value, ast.Name)
                            and node.value.id == "torch"):
                        found.append((where, node.attr))
                elif isinstance(node, ast.Name) \
                        and node.id == "scaled_dot_product_attention":
                    found.append((where, node.id))
                elif isinstance(node, ast.Import):
                    found += [(where, a.name) for a in node.names
                              if a.name.split(".")[0] == "flash_attn"]
                elif isinstance(node, ast.ImportFrom):
                    mod = node.module or ""
                    if mod.split(".")[0] == "flash_attn" or any(
                            a.name in ("scaled_dot_product_attention",
                                       "compile") and mod.startswith("torch")
                            for a in node.names):
                        found.append((where, mod))
    assert not found, found


def _kernel_calls():
    """Each LM kernel entry with inputs at a tiny shape that requires
    grad (``x``) — name, call."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru_scan import ops as rg
    from repro_torch.kernels.ssd_scan import ops as ssd

    def t(*shape):
        return torch.rand(shape)

    def g(*shape):
        return torch.rand(shape).requires_grad_(True)
    pos = torch.arange(4, dtype=torch.int32)
    valid = torch.ones((2, 4), dtype=torch.int32)
    return [
        ("flash_attention_fwd", lambda: fa.flash_attention_fwd(
            g(2, 4, 8), t(2, 4, 8), t(2, 4, 8))),
        ("flash_attention", lambda: fa.flash_attention(
            t(1, 4, 2, 8), t(1, 4, 2, 8), g(1, 4, 2, 8), pos, pos,
            mask_kind="causal")),
        ("decode_attention_fwd", lambda: da.decode_attention_fwd(
            t(2, 1, 8), g(2, 4, 8), t(2, 4, 8), valid)),
        ("decode_attention", lambda: da.decode_attention(
            g(1, 1, 2, 8), t(1, 4, 2, 8), t(1, 4, 2, 8), 3)),
        ("ssd_scan_fwd", lambda: ssd.ssd_scan_fwd(
            t(2, 4, 8), g(2, 4), -t(2, 1), t(1, 4, 3), t(1, 4, 3),
            heads=2, chunk=2)),
        ("ssd_scan", lambda: ssd.ssd_scan(
            g(1, 4, 2, 8), t(1, 4, 2), -t(2), t(1, 4, 3), t(1, 4, 3), 2)),
        ("rglru_scan_fwd", lambda: rg.rglru_scan_fwd(g(1, 4, 3),
                                                     t(1, 4, 3))),
        ("rglru_scan", lambda: rg.rglru_scan(t(1, 4, 3), g(1, 4, 3))),
    ]


def test_lm_kernel_entries_refuse_a_graph_on_the_cpu():
    """Under autograd every LM kernel entry raises, on CPU tensors too
    (where its plain version would differentiate): the kernel has no
    backward, and on the card it would lose the gradient in silence.
    Without grad, or with no input requiring it, it runs."""
    for name, call in _kernel_calls():
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
        with torch.no_grad():
            call()
        with torch.inference_mode():
            call()


def _loss_and_grads(cfg, params, batch, impl="pallas"):
    from repro_torch import _tree
    from repro_torch.models import loss_fn
    flat, treedef = _tree.flatten(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    loss = loss_fn(_tree.unflatten(treedef, live), batch, cfg, impl=impl)
    return loss, torch.autograd.grad(loss, live)


def test_forward_under_grad_with_auto_attention_equals_dense():
    """``attn_impl="auto"`` under autograd takes the reference's rule
    (dense at these lengths): the loss and every gradient equal
    ``"dense"``'s exactly; ``"chunked"`` is the plain chunked scan
    (float32 to 1e-5 of each leaf's largest |g|); ``"pallas"`` raises.
    SSD and RG-LRU mixers: ``impl="pallas"`` raises under autograd."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    base = dataclasses.replace(get_smoke_config("paper_edge"),
                               dtype="float32")
    params = init_params(base, 0, device="cpu")
    batch = {"tokens": torch.randint(0, base.vocab_size, (2, 20),
                                     generator=torch.Generator()
                                     .manual_seed(0))}
    runs = {impl: _loss_and_grads(dataclasses.replace(
        base, attn_impl=impl, attn_chunk=8), params, batch)
        for impl in ("dense", "auto", "chunked")}
    assert runs["auto"][0].item() == runs["dense"][0].item()
    for a, b in zip(runs["auto"][1], runs["dense"][1]):
        assert torch.equal(a, b)
    for a, b in zip(runs["chunked"][1], runs["dense"][1]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    with pytest.raises(RuntimeError, match="has no backward"):
        _loss_and_grads(dataclasses.replace(base, attn_impl="pallas"),
                        params, batch)
    for arch in ("mamba2_130m", "recurrentgemma_9b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        p = init_params(cfg, 0, device="cpu")
        with pytest.raises(RuntimeError, match="has no backward"):
            _loss_and_grads(cfg, p, batch, impl="pallas")
        loss, grads = _loss_and_grads(cfg, p, batch, impl="jnp")
        assert torch.isfinite(loss) and all(
            torch.isfinite(g).all() for g in grads)
