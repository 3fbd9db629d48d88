"""BENCHMARK.json against the benchmark's contract: every cell,
configuration, traffic mix and metric resolves to its file; names, units,
bounds, layers and lists keep their limits; no module the benchmark runs
loads JAX or the JAX package, and the plain reference imports nothing of
the program."""
import ast
import os
import re
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from portbench import harness   # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()


def test_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    cells = SPEC["workloads"]
    assert 1 <= len(cells) <= 24
    # a full check of 24 cells fits its 43,200 s
    n = 24
    assert (2 + 14 * n) * (SPEC["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200
    names = [c["name"] for c in SPEC["configs"] + cells + SPEC["end_to_end"]
             + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[group]}) == len(SPEC[group])
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert "setup_s" in metrics
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_cell_resolves(cell):
    c = harness.find(SPEC["workloads"], cell, "workload")
    assert c["chips"] == 1 and len(c["why"]) <= 200
    conf = harness.find(SPEC["configs"], c["config"], "config")
    assert conf["file"].startswith("portbench/configs/")
    cfg = harness.load_json(os.path.join(ROOT, conf["file"]))
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    mix = harness.load_json(harness.traffic_path(c["traffic"]))
    assert os.path.exists(os.path.join(HERE, "drivers",
                                       mix["driver"] + ".py"))
    e2e = harness.cell_metrics(SPEC, cell, "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = harness.cell_metrics(SPEC, cell, "per_layer")
    assert layer
    for m in e2e + layer:
        assert harness.metric_path(m["name"]).exists(), m["name"]


def test_every_config_used():
    used = {c["config"] for c in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


BANNED = ("jax", "jaxlib", "flax", "repro")


def imports_of(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = imports_of(os.path.join(ref, name))
            assert not tops & set(BANNED + ("repro_torch",)), name


def test_no_module_loads_jax():
    """A whole small run in a fresh process: no module of top-level name
    jax, jaxlib, flax or repro (compared whole: repro_torch is the port)
    is loaded."""
    code = (
        "import sys, torch; sys.path.insert(0, 'portbench');"
        "import run; run.environment();"
        "from portbench import tiny;"
        "torch.set_num_threads(1);"
        "run.run('pool_bulk', 7, 0.1, False, device=torch.device('cpu'),"
        " config_overrides=tiny.ZONE);"
        "from portbench import harness;"
        "print(harness.loaded_banned(), harness.refuse_banned())")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH",)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] False"


def test_no_card_no_result():
    """Without a card the command exits with another code than 0 and
    prints nothing on standard output."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "pool_bulk",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def test_trace_reduction():
    """Busy time is the union of device ops; an annotation the profiler
    mirrors onto the device does not count; gaps go to the host span
    under them."""
    class E:
        def __init__(self, name, dev, start, dur, act):
            self._v = (name, dev, start, dur, act)

        def name(self):
            return self._v[0]

        def device_type(self):
            return self._v[1]

        def start_ns(self):
            return self._v[2]

        def duration_ns(self):
            return self._v[3]

        def activity_type(self):
            return self._v[4]
    ev = [E("pb.window", "DeviceType.CPU", 0, 100, "user_annotation"),
          E("pb.commit", "DeviceType.CPU", 10, 30, "user_annotation"),
          E("pb.commit", "DeviceType.CUDA", 10, 80, "gpu_user_annotation"),
          E("pb.traffic", "DeviceType.CPU", 50, 40, "user_annotation"),
          E("void commit_pages<0, false>(int)", "DeviceType.CUDA", 20, 10,
            "kernel"),
          E("at::native::copy(x)", "DeviceType.CUDA", 25, 10, "kernel"),
          E("Memcpy DtoD", "DeviceType.CUDA", 60, 20, "gpu_memcpy")]
    out = harness.reduce_trace(ev)
    assert out["busy_s"] == 35e-9 and out["window_s"] == 100e-9
    assert out["protection_s"] == 10e-9
    gaps = dict(out["idle_gaps"])
    assert gaps["commit"] == 20e-9 and gaps["traffic"] == 20e-9
    assert gaps["outside any benchmark span"] == 25e-9
    assert dict(out["device_ops"])["commit_pages<0, false>"] == 10e-9

