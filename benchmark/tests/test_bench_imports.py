"""Nothing the benchmark runs loads JAX or the JAX package, checked by the
whole top-level module name (``video_spike_torch`` begins with
``video_spike_t`` and is not ``video_spike_tpu``)."""

import json
import os
import subprocess
import sys

import tiny_cells  # noqa: F401
from benchlib import guard, spec


def test_guard_compares_whole_top_level_names():
    mods = ["video_spike_torch", "video_spike_torch.ops.optim",
            "video_spike_t", "jaxtyping", "flaxen", "numpy"]
    assert guard.forbidden_loaded(mods) == []
    assert guard.forbidden_loaded(mods + ["jax.numpy", "video_spike_tpu.x",
                                          "optax"]) == [
        "jax", "optax", "video_spike_tpu"]


PROBE = r"""
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {bench!r})
import run
run.set_cache_dirs()
from benchlib import guard, spec, compare, counts, intervals, plain, report
from benchlib import steps, trace, supervised, contrast
for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]:
    cell = spec.find_cell(w["name"])
    cell.reference()
    for m in cell.per_layer:
        cell.metric_reader(m["name"])
    b = supervised.build if cell.config["trainer"] == "supervised" else None
import video_spike_torch.train.base, video_spike_torch.train.contrast
import video_spike_torch.core.registry as r
for name in ("Linear", "ContrastViTMAE"):
    r.NAME2MODEL[name]
import video_spike_torch.ops.fused_readout, video_spike_torch.core.runtime
import video_spike_torch.data.contrast, video_spike_torch.parallel.multihost
print(json.dumps(guard.forbidden_loaded()))
"""


def test_nothing_run_imports_loads_jax():
    code = PROBE.format(root=str(spec.ROOT), bench=str(spec.BENCH_DIR))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(spec.ROOT), env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
