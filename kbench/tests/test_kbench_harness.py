"""The harness on the CPU, at the narrow configuration of tests/data: a run
drives set-up, the window, the traced window and the comparison without
the look for a card; new configurations, traffic mixes, cells and metrics
are found by name from files added beside the others; the last line's
shape; the check for JAX; and the comparison's verdict on a timed path
broken underneath (a stale answer, half the batch left out, one answer
altered) and on the control (the program's products on TF32 operands)."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from kbench import harness

ROOT = harness.ROOT
DATA = os.path.join(ROOT, "kbench", "tests", "data")
TINY = "tiny-stoch-16"
CELL = "tiny.b32"
LIMIT = 1e-4


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout root with this kbench, its BENCHMARK.json plus the narrow
    configuration and a cell of it on the b32 mix, and a snapshot cache of
    its own."""
    d = tmp_path_factory.mktemp("root")
    shutil.copytree(os.path.join(ROOT, "kbench"), d / "kbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    for ext in (".json", ".py"):
        shutil.copy(os.path.join(DATA, TINY + ext), d / "kbench" / "configs")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": TINY, "source": "kbench CPU tests", "reduced": [],
                             "file": "kbench/configs/%s.json" % TINY, "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": TINY, "traffic": "b32",
                               "chips": 1, "why": "tests"})
    with open(d / "kbench" / "workloads" / (CELL + ".json"), "w") as f:
        json.dump({"correct": {"max_rel_err": LIMIT}}, f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    with open(d / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return str(d)


def run(root, cell, trace=False, seconds=0.3, seed=2 ** 31 + 11):
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(), root=root,
                            device="cpu")


@pytest.mark.parametrize("trace", [False, True])
def test_cpu_run(root, trace):
    cell = CELL
    result, compared = run(root, cell, trace)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert list(result)[-1] == "compared" and list(result)[:5] == \
        ["correct", "attempted", "failed", "metrics", "device"]
    assert compared == [("max_rel_err", result["compared"]["max_rel_err"]["value"], LIMIT)]
    assert 0 < compared[0][1] < LIMIT
    bench = harness.Cell(root, cell).bench
    entries = [m for m in (bench["per_layer"] if trace else bench["end_to_end"])
               if cell in m.get("workloads", (cell,))]
    # on the CPU the readers of the card's trace and memory, and of the
    # program's spans in that trace, find nothing; every other metric reads
    absent = {m["name"] for m in entries if m["source"] in ("device_trace", "program_span")}
    assert set(result["metrics"]) == {m["name"] for m in entries} - absent
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["window_s"] > 0


def test_snapshot_is_reused_and_named_by_its_digest(root):
    import keynet_tpu_torch as kt
    cell = harness.Cell(root, CELL)
    cache = os.path.join(root, "kbench", "cache")
    path, converted = harness.ensure_snapshot(kt, cell, cache)
    assert not converted and os.path.exists(path)
    program = os.path.dirname(os.path.dirname(kt.__file__))
    assert path.endswith("%s-%s.npz" % (TINY, harness.snapshot_digest(cell, program)))
    stale = os.path.join(cache, TINY + "-0000000000000000.npz")
    shutil.copy(path, stale)
    cfg = os.path.join(root, "kbench", "configs", TINY + ".json")
    with open(cfg) as f:
        text = f.read()
    try:
        with open(cfg, "w") as f:       # another configuration file: another digest
            f.write(text.replace('"seed": 3', '"seed": 4'))
        cell2 = harness.Cell(root, CELL)
        path2, converted = harness.ensure_snapshot(kt, cell2, cache)
        assert converted and path2 != path
        assert not os.path.exists(path) and not os.path.exists(stale)
    finally:
        with open(cfg, "w") as f:
            f.write(text)


def test_new_files_are_found_by_name(root, tmp_path):
    """A traffic mix, a cell, a configuration and a per-layer metric are
    added by adding files and entries only."""
    d = tmp_path / "root"
    shutil.copytree(root, d, ignore=shutil.ignore_patterns("cache", "__pycache__"))
    k = d / "kbench"
    (k / "traffic" / "b1.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "batch": 1, "pool": 8, "warmup_requests": 1,
         "trace_seconds": 0.2}))
    shutil.copy(k / "configs" / (TINY + ".json"), k / "configs" / "tiny-copy.json")
    shutil.copy(k / "configs" / (TINY + ".py"), k / "configs" / "tiny-copy.py")
    (k / "workloads" / "tiny-copy.b1.json").write_text(
        json.dumps({"correct": {"max_rel_err": LIMIT}}))
    (k / "metrics" / "requests_traced.b1.py").write_text(
        "def read(record):\n    return len(record['trace_requests'])\n")
    bench = json.loads((d / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-copy", "source": "x", "reduced": [],
                             "file": "kbench/configs/tiny-copy.json", "why": "x"})
    bench["workloads"].append({"name": "tiny-copy.b1", "config": "tiny-copy",
                               "traffic": "b1", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("tiny-copy.b1")
    bench["per_layer"].append({"name": "requests_traced.b1", "unit": "req", "better": "higher",
                               "source": "host_clock", "layer": "x", "moves": "imgs_per_s",
                               "workloads": ["tiny-copy.b1"]})
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell(str(d), "tiny-copy.b1")
    assert cell.traffic["batch"] == 1 and cell.cfg["inshape"] == [3, 16, 16]
    assert [m["name"] for m in cell.metrics(True)] == ["requests_traced.b1"]
    assert {m["name"] for m in cell.metrics(False)} == {"imgs_per_s", "device_mem_gib",
                                                       "setup_s"}
    result, _ = run(str(d), "tiny-copy.b1", trace=True, seconds=0.2)
    assert result["correct"] and result["metrics"]["requests_traced.b1"]["value"] > 0


def test_forbidden_modules_compare_whole_top_level_names():
    fake = dict.fromkeys(["keynet_tpu_torch", "keynet_tpu_torch.ops", "jaxtyping", "numpy",
                          "keynet_tpu", "keynet_tpu.ops.operators", "jax.numpy",
                          "jaxlib", "flax.linen", "kbench"])
    assert harness.forbidden_modules(fake) == ["flax.linen", "jax.numpy", "jaxlib",
                                               "keynet_tpu", "keynet_tpu.ops.operators"]


def test_harness_and_program_load_no_jax():
    """A fresh process that imports every module of the harness, the readers
    and the references, and keynet_tpu_torch with the modules a run loads,
    holds no module of JAX or the JAX package."""
    code = ("import glob, os, sys; sys.path.insert(0, %r)\n"
            "from kbench import harness, yardstick, weights\n"
            "import keynet_tpu_torch, keynet_tpu_torch.ops.block_ell, torch.profiler\n"
            "for p in glob.glob(os.path.join(%r, 'kbench', '*', '*.py')):\n"
            "    if '/tests/' not in p: harness.load_module(p, 'm_' + str(abs(hash(p))))\n"
            "harness.load_module(os.path.join(%r, 'kbench', 'run.py'), 'kbench_run')\n"
            "print(harness.forbidden_modules())\n") % (ROOT, ROOT, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_last_line_shape(monkeypatch, capsys):
    """run.main on a faked run: the result is the last line of standard
    output, the numbers compared are the last lines of standard error."""
    run_mod = harness.load_module(os.path.join(ROOT, "kbench", "run.py"), "kbench_run_t")
    fake = {"correct": True, "attempted": 3, "failed": 0,
            "metrics": {"imgs_per_s": {"value": 1.5, "unit": "imgs/s"}},
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                       "memory_peak_bytes": 7},
            "compared": {"max_rel_err": {"value": 1e-6, "limit": 1e-3}}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "card", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(harness, "cache_env", lambda root: None)
    monkeypatch.setattr(harness, "run_cell",
                        lambda *a, **k: (fake, [("max_rel_err", 1e-6, 1e-3)]))
    assert run_mod.main(["--workload", "vgg16-orth-224.b32", "--seed", str(2 ** 31 + 3),
                         "--seconds", "10", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == fake
    assert err.strip().splitlines()[-1] == "compared max_rel_err 1e-06 limit 0.001"


def test_no_result_without_a_card(monkeypatch, capsys):
    run_mod = harness.load_module(os.path.join(ROOT, "kbench", "run.py"), "kbench_run_t2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_mod.main(["--workload", "vgg16-orth-224.b32", "--seed", "1",
                         "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_no_result_with_jax_loaded(monkeypatch, capsys):
    run_mod = harness.load_module(os.path.join(ROOT, "kbench", "run.py"), "kbench_run_t3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "card", lambda: "card")
    monkeypatch.setattr(harness, "cache_env", lambda root: None)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: ({}, []))
    monkeypatch.setitem(sys.modules, "keynet_tpu.ops", sys.modules["kbench"])
    assert run_mod.main(["--workload", "vgg16-orth-224.b32", "--seed", "1",
                         "--seconds", "1"]) == 3
    out, err = capsys.readouterr()
    assert out == "" and "keynet_tpu.ops" in err


def test_no_result_outside_a_checkout(tmp_path):
    """In a directory that holds only BENCHMARK.json and kbench/, the run
    cannot import the program and prints no result."""
    shutil.copytree(os.path.join(ROOT, "kbench"), tmp_path / "kbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "kbench/run.py", "--workload",
                          "allconv-stoch-32.b1024", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0 and out.stdout == ""


# ------------------------------------------------------------ broken timed paths

def _break(monkeypatch, how):
    """Replace KeyedModel.forward with a broken one."""
    from keynet_tpu_torch.system import KeyedModel
    real = KeyedModel.forward
    state = {"n": 0, "last": None}

    def forward(self, x, *a, **k):
        y = real(self, x, *a, **k)
        state["n"] += 1
        if how == "stale":               # the state of the last request, unchanged
            y, state["last"] = (y if state["last"] is None else state["last"]), y
        elif how == "half":              # half of the batch left out, the mean in its place
            h = y.shape[0] // 2
            y = torch.cat([y[:h], y[:h].mean(0, keepdim=True).expand(y.shape[0] - h, -1)])
        elif how == "altered" and state["n"] % 50 == 0:   # one answer in 50 altered
            y = y.clone()
            y[-1, 3] += 1e-3 * float(y.abs().max())
        return y
    monkeypatch.setattr(KeyedModel, "forward", forward)


def _run_at_least(root, n, seconds=0.5):
    """A run whose window holds at least ``n`` requests.  The window is
    timed, so a loaded host fits fewer requests into 0.5 s (21 in one
    such run): the window is doubled until it holds ``n``, up to 8 s."""
    while True:
        result, compared = run(root, CELL, seconds=seconds)
        if result["attempted"] >= n or seconds >= 8:
            return result, compared
        seconds *= 2


@pytest.mark.parametrize("how", ["stale", "half", "altered"])
def test_broken_timed_path_is_not_correct(root, monkeypatch, how):
    result, compared = run(root, CELL, seconds=0.5)
    assert result["correct"]
    _break(monkeypatch, how)
    result, compared = _run_at_least(root, 50)
    assert result["attempted"] >= 50
    assert result["correct"] is False and result["failed"] >= 1
    assert compared[0][1] > LIMIT


def _tf32(t):
    """float32 rounded as the tensor cores take a TF32 operand: the low 13
    mantissa bits dropped."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def test_control_is_not_correct(root, monkeypatch):
    """The control on the CPU: the program with every operator's input
    rounded to TF32, as PRECISION='default' runs its products on the card
    (the CPU keeps IEEE products in every mode)."""
    from keynet_tpu_torch.ops import operators
    for cls in vars(operators).values():
        if isinstance(cls, type) and issubclass(cls, operators.LinearOp) \
                and "apply" in vars(cls) and cls is not operators.ChainedOp:
            monkeypatch.setattr(cls, "apply", (lambda f: lambda self, x: f(self, _tf32(x)))(
                vars(cls)["apply"]))
    result, compared = run(root, CELL, seconds=0.3)
    assert result["correct"] is False
    assert compared[0][1] > 3 * LIMIT, compared
