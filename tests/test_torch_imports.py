"""The port stands alone: every `repro_torch` module imports with jax made
unimportable, and no file of the port (nor chip_smoke.py) imports jax or
anything of `repro`. Also the port's CPU-side guards: the weight bridge keeps
bf16 bits, the engine refuses what is not ported yet and a CUDA device
without a card, and chip_smoke.py prints no result without a card."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_storable, params_from_numpy
from repro_torch.common.registry import get_arch
from repro_torch.config import RuntimeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.models import get_model
from repro_torch.serving import ServingEngine, SpecDecodeConfig
from repro_torch.sharding.param import init_params

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert "repro_torch.serving.engine" in mods and len(mods) > 25
    script = ("import importlib, sys\n"
              "sys.modules['jax'] = None\n"
              "sys.modules['repro'] = None\n"
              f"for m in {mods!r}:\n"
              "    importlib.import_module(m)\n"
              "assert not any(k == 'jax' or k.startswith('jax.') "
              "for k, v in sys.modules.items() if v is not None)\n"
              "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", script], env=_env(),
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_paper_model_configs_resolve_without_jax():
    """The paper's three models resolve from the port's registry with jax
    and the JAX package unimportable, and the registry lists them beside
    mamba2-370m, qwen2.5-32b and the hybrid and MoE configs."""
    script = ("import sys\n"
              "sys.modules['jax'] = None\n"
              "sys.modules['repro'] = None\n"
              "from repro_torch.common.registry import get_arch, list_archs\n"
              "names = ('hermes2-pro-8b', 'llama3.1-8b', "
              "'carboncall-qwen2-7b')\n"
              "assert [get_arch(n).name for n in names] == list(names)\n"
              "assert set(names) | {'mamba2-370m', 'qwen2.5-32b', "
              "'zamba2-7b', 'phi3.5-moe-42b-a6.6b', "
              "'llama4-scout-17b-a16e'} == set(list_archs())\n"
              "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", script], env=_env(),
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_core_import_builds_nothing():
    """`import repro_torch.core` loads no kernel library, makes no weights
    and does not start CUDA."""
    script = ("import torch\n"
              "import repro_torch.core\n"
              "from repro_torch.kernels import build\n"
              "assert build._LIBS == {}, build._LIBS\n"
              "assert not torch.cuda.is_initialized()\n"
              "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", script], env=_env(),
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = []
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "repro", "flax", "ml_dtypes"):
                bad.append(f"{path.relative_to(REPO)}: {name}")
    assert bad == []


def test_bridge_keeps_bf16_bits():
    rng = np.random.default_rng(0)
    t = torch.as_tensor(rng.standard_normal((5, 7)),
                        dtype=torch.float32).bfloat16()
    arr = t.view(torch.int16).numpy().view(np.uint16)
    assert torch.equal(from_storable(arr, "bfloat16"), t)
    tree = params_from_numpy({"a": (arr, "bfloat16"),
                              "b": {"c": np.arange(4, dtype=np.int8)}})
    assert tree["a"].dtype == torch.bfloat16 and torch.equal(tree["a"], t)
    assert tree["b"]["c"].dtype == torch.int8


@pytest.fixture(scope="module")
def tiny():
    cfg = reduce_config(get_arch("carboncall-qwen2-7b"))
    params = init_params(get_model(cfg).param_spec(),
                         torch.Generator().manual_seed(0), "cpu")
    return cfg, params


@pytest.mark.parametrize("kw,exc,match", [
    # the transformer's dense layout is served, with chunked prefill (its
    # window unrounded) as in the JAX package; speculative decoding on it is
    # the JAX package's ValueError, the data-parallel mesh is not ported
    pytest.param({"prefill_chunk": 30, "kv_layout": "dense"}, None, None,
                 id="kw0"),
    pytest.param({"spec_decode": SpecDecodeConfig(), "kv_layout": "dense"},
                 ValueError, "requires the paged KV layout", id="kw1"),
    pytest.param({"kv_layout": "dense"}, None, None, id="kw2"),
    pytest.param({"mesh": object()}, NotImplementedError, "ROADMAP",
                 id="kw3")])
def test_engine_refuses_unported_options(tiny, kw, exc, match):
    cfg, params = tiny
    if exc is None:
        eng = ServingEngine(cfg, params, RuntimeConfig(), device="cpu", **kw)
        assert eng.kv_layout == "dense"
        assert eng.prefill_chunk == kw.get("prefill_chunk")
        L, K, H = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        assert tuple(eng.cache["k"].shape) == (L, eng.max_batch,
                                               eng.max_seq, K, H)
        return
    with pytest.raises(exc, match=match):
        ServingEngine(cfg, params, RuntimeConfig(), device="cpu", **kw)


def test_engine_on_cuda_needs_a_card(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the guard is for hosts without")
    cfg, params = tiny
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ServingEngine(cfg, params, RuntimeConfig())


def test_int8_pool_autosizes_to_the_bf16_budget(tiny):
    cfg, params = tiny
    n = {kv: ServingEngine(cfg, params, RuntimeConfig(kv_cache_dtype=kv),
                           device="cpu").block_pool.num_blocks
         for kv in ("bf16", "int8")}
    H = cfg.resolved_head_dim
    assert n["int8"] - 1 == ((n["bf16"] - 1) * 2 * H) // (H + 4)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card: exit non-zero, no result line. Alone in a directory (no
    src/repro_torch beside it): the same."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", script)
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_worker_launcher_imports_without_torch():
    """`repro_torch.launch.workers` (what a spawned worker imports before it
    reaches its device) and `repro_torch.serving.protocol` import in a fresh
    interpreter with torch unimportable (the lazy `repro_torch.serving`);
    `core.fleet`, `launch.workers` and `launch.serve` import with jax and
    the JAX package unimportable."""
    no_torch = ("import sys\n"
                "for m in ('torch', 'jax', 'repro'):\n"
                "    sys.modules[m] = None\n"
                "import repro_torch.launch.workers\n"
                "import repro_torch.serving.protocol\n"
                "from repro_torch.serving import EngineStats, WorkerSpec\n"
                "assert WorkerSpec().to_wire()['v'] >= 1\n"
                "loaded = [k for k, v in sys.modules.items() if v is not None]\n"
                "assert not any(k.split('.')[0] in ('torch', 'jax') "
                "for k in loaded), loaded\n"
                "print('ok')\n")
    no_jax = ("import sys\n"
              "sys.modules['jax'] = None\n"
              "sys.modules['repro'] = None\n"
              "import repro_torch.core.fleet\n"
              "import repro_torch.launch.workers\n"
              "import repro_torch.launch.serve\n"
              "print('ok')\n")
    for script in (no_torch, no_jax):
        proc = subprocess.run([sys.executable, "-c", script], env=_env(),
                              cwd=REPO, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == "ok"


def test_fleet_and_workers_default_to_the_card():
    """An engine-backed fleet builds its first routed pod's engine
    (`ensure_client`) on the card unless `build_fleet` was given
    device="cpu", and so does its default tool selector; `launch_workers`
    and `EngineActor` default to the card too. Without a card each raises;
    with device="cpu" the fleet serves."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    from repro_torch.core import ToolSelector
    from repro_torch.core.fleet import (FleetSpec, RegionSpec, build_fleet,
                                        run_fleet)
    from repro_torch.data.workload import FunctionCallWorkload, build_catalog
    from repro_torch.launch.workers import EngineActor, launch_workers
    from repro_torch.serving import EngineConfig, WorkerSpec

    spec = FleetSpec(regions=(RegionSpec("clean", pods=(("edge", 1),)),))
    catalog = build_catalog(32, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_fleet(spec, catalog=catalog)
    sel = ToolSelector(catalog, device="cpu")
    fleet = build_fleet(spec, catalog=catalog, selector=sel)
    assert fleet.pods[0].device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_fleet(fleet, FunctionCallWorkload(catalog, seed=0), n_steps=1,
                  queries_per_hour=60.0, backend="engine")
    fleet = build_fleet(spec, catalog=catalog, selector=sel, device="cpu")
    recs = run_fleet(fleet, FunctionCallWorkload(catalog, seed=0),
                     n_steps=1, queries_per_hour=60.0, backend="engine")
    assert len(recs[0]) > 0 and fleet.built_pods() == fleet.pods
    assert fleet.pods[0].runtime.executor.engine.device.type == "cpu"
    wspec = WorkerSpec(config=EngineConfig(max_batch=2), label="card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_workers([wspec])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        EngineActor(wspec)
