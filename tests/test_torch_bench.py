"""The port's bench (superconductor_tpu_torch/bench.py) on the CPU: the
counterpart of tests/test_bench_harness.py.

The slope arithmetic runs on a fake clock (a frame costs a known time, the
barrier another), and equals the JAX bench's measure_frame_slope driven by
the same clock; the budget skip and the error report of
measure_device_delta; the caps cache (its key, a round trip, and a hit
equal to what fit_caps fits at 256x128); main end to end on the CPU with
the fake clock, a run without a card, and a deliberately wrong frame that
makes main exit non-zero; and that the bench imports neither jax, the JAX
package nor the root bench.py. No time is asserted from a real clock."""

import ast
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from superconductor_tpu_torch import bench
from superconductor_tpu_torch.ops import raster as raster_mod
from superconductor_tpu_torch.render import frame as frame_mod
from superconductor_tpu_torch.render.caps import fit_caps
from superconductor_tpu_torch.scenes import HERO_GLB, headline_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as ref_bench  # noqa: E402  (the JAX system's bench.py)

FRAME_S = 0.060  # a frame's cost on the fake clock
BARRIER_S = 0.004  # one synchronise's
FIRST_S = 1.5  # the first call's extra (kernel build, warm-up)


class FakeClock:
    """bench.HostClock's interface over a virtual time `t` in seconds: each
    barrier costs `barrier_s`; frames advance `t` themselves."""

    def __init__(self, device=None, barrier_s=BARRIER_S):
        self.t = 0.0
        self.barrier_s = barrier_s
        self.syncs = 0

    def sync(self):
        self.t += self.barrier_s
        self.syncs += 1

    def now(self):
        return self.t


def _frame_fn(clock, frame_s=FRAME_S):
    calls = []

    def fn():
        clock.t += frame_s + (FIRST_S if not calls else 0.0)
        calls.append(1)
        return np.zeros((1, 4, 4, 4), np.uint8)

    fn.calls = calls
    return fn


@pytest.mark.parametrize("ns", [(1, 2, 8), (1, 4)], ids=["three_point", "two_point"])
def test_frame_slope_on_a_fake_clock(ns):
    """The slope recovers a frame's cost and cancels the barrier; the
    neighbouring slopes bracket it; rtt_ms is one barrier; compile_s the
    first call; the repeats agree, so the spread is 0."""
    clock = FakeClock()
    fn = _frame_fn(clock)
    r = bench.measure_frame_slope(fn, ns=ns, calls=3, repeats=3, clock=clock)
    assert r["frame_ms"] == pytest.approx(FRAME_S * 1e3)
    assert r["frame_check_ms"] == pytest.approx([FRAME_S * 1e3] * (len(ns) - 1))
    assert r["frame_spread"] == pytest.approx(0.0, abs=1e-9)
    assert r["rtt_ms"] == pytest.approx(BARRIER_S * 1e3)
    assert r["compile_s"] == pytest.approx(FIRST_S + FRAME_S + BARRIER_S)
    assert len(fn.calls) == 1 + 3 * 3 * sum(ns)


@pytest.mark.parametrize("ns", [(1, 2, 8), (1, 4)], ids=["three_point", "two_point"])
def test_frame_slope_equals_the_jax_benchs(ns, monkeypatch):
    """The JAX bench's measure_frame_slope (its time module on the same
    virtual clock) and the port's give the same slope, checks and spread.
    Frames cost 60 ms, 63 ms from the 20th timed one on, so the repeats
    differ. The JAX bench dispatches one more frame for its readback probe
    (its second call), which costs nothing here and is not counted."""
    def run(measure, clock, free=()):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) - 1 in free:
                return np.zeros((1, 4, 4, 4), np.uint8)
            i = len(calls) - 1 - sum(f < len(calls) for f in free)
            clock.t += 0.060 + (FIRST_S if i == 0 else 0.0) + (0.003 if i >= 20 else 0.0)
            return np.zeros((1, 4, 4, 4), np.uint8)

        return measure(fn)

    clock = FakeClock(barrier_s=0.0)
    port = run(lambda fn: bench.measure_frame_slope(fn, ns=ns, clock=clock), clock)
    ref_clock = FakeClock(barrier_s=0.0)
    fake_time = types.SimpleNamespace(time=ref_clock.now, perf_counter=ref_clock.now)
    monkeypatch.setattr(ref_bench, "time", fake_time)
    ref = run(lambda fn: ref_bench.measure_frame_slope(fn, ns=ns), ref_clock, free=(1,))
    for key in ("frame_ms", "frame_spread", "compile_s"):
        assert port[key] == pytest.approx(ref[key], rel=1e-9), key
    assert port["frame_check_ms"] == pytest.approx(ref["frame_check_ms"], rel=1e-9)
    assert port["frame_spread"] > 0


def test_measure_windows_on_a_fake_clock():
    """_measure: fps over windows of frames that build their own state, and
    device_ms over replays of one built frame, barrier included."""
    clock = FakeClock()
    build_s = 0.010
    fn = _frame_fn(clock)

    def frame_fn(t):
        clock.t += build_s
        return fn()

    r = bench._measure(frame_fn, fn, n=10, windows=2, device_windows=2, device_n=10,
                       clock=clock)
    assert r["fps"] == pytest.approx(10 / (10 * (FRAME_S + build_s) + BARRIER_S))
    assert r["device_ms"] == pytest.approx((10 * FRAME_S + BARRIER_S) * 1e3 / 10)
    assert r["device_spread"] == pytest.approx(0.0, abs=1e-9)
    assert r["compile_s"] == pytest.approx(build_s + FIRST_S + FRAME_S + BARRIER_S)


def test_budget_skips_and_marks():
    calls = []

    def spy():
        calls.append(1)

    r = {"tag": "tb", "frame_fn": spy}
    bench.measure_device_delta([r], budget_s=1.0, t_start=__import__("time").time() - 10.0,
                               clock=FakeClock())
    assert r["delta_error"] == "skipped: bench budget"
    assert "frame_ms" not in r
    assert not calls  # never dispatched


def test_delta_error_reported_not_raised():
    def boom():
        raise RuntimeError("device fell over")

    ok = {"tag": "ok", "frame_fn": _frame_fn(clock := FakeClock())}
    r = {"tag": "te", "frame_fn": boom}
    bench.measure_device_delta([r, ok], ns=(1, 4), clock=clock)
    assert r["delta_error"].startswith("RuntimeError: device fell over")
    assert ok["frame_ms"] == pytest.approx(FRAME_S * 1e3)  # the next one still ran


def test_caps_cache_key(tmp_path, monkeypatch):
    """The key changes with the size, the scene's cuts, the fixture's bytes
    and each of the kernels' cluster constants, and with nothing else."""
    fixture = tmp_path / "f.glb"
    fixture.write_bytes(b"abc")
    key = bench._caps_cache_key("headline", 256, 128, [str(fixture)])
    assert key == bench._caps_cache_key("headline", 256, 128, [str(fixture)])
    assert key.startswith("headline-256x128-")
    assert key != bench._caps_cache_key("headline", 256, 64, [str(fixture)])
    assert key != bench._caps_cache_key("headline", 256, 128, [str(fixture)], {"stacks": 8})
    fixture.write_bytes(b"abd")
    assert key != bench._caps_cache_key("headline", 256, 128, [str(fixture)])
    fixture.write_bytes(b"abc")
    for name in ("RASTER_CLUSTER", "KBUFFER_CLUSTER", "KBUFFER_DEEP_CLUSTER"):
        with monkeypatch.context() as m:
            m.setattr(raster_mod, name, getattr(raster_mod, name) + 1)
            assert key != bench._caps_cache_key("headline", 256, 128, [str(fixture)]), name
    assert key == bench._caps_cache_key("headline", 256, 128, [str(fixture)])


def test_caps_cache_round_trip(tmp_path, monkeypatch):
    """Store then load gives the caps back (tuples as tuples), other keys
    survive a store, SC_BENCH_REFIT ignores the cache, and the file is the
    port's own under build/, never bench_caps.json."""
    assert os.path.dirname(bench.CAPS_CACHE_PATH) == raster_mod.BUILD_DIR
    assert os.path.basename(bench.CAPS_CACHE_PATH) != "bench_caps.json"
    monkeypatch.setattr(bench, "CAPS_CACHE_PATH", str(tmp_path / "caps.json"))
    monkeypatch.delenv("SC_BENCH_REFIT", raising=False)
    cfg = frame_mod.RenderConfig(p_cap=9216, opaque_px_cap=688128, shade_px_caps=(512, 1024))
    assert bench._caps_cache_load("a") is None
    bench._caps_cache_store("a", cfg)
    bench._caps_cache_store("b", frame_mod.RenderConfig(p_cap=7))
    entry = bench._caps_cache_load("a")
    assert entry["p_cap"] == 9216 and entry["opaque_px_cap"] == 688128
    assert entry["shade_px_caps"] == (512, 1024) and entry["clip_px_caps"] is None
    assert bench._caps_cache_load("b")["p_cap"] == 7
    monkeypatch.setenv("SC_BENCH_REFIT", "1")
    assert bench._caps_cache_load("a") is None


def test_caps_cache_hit_equals_fitted(tmp_path, monkeypatch):
    """fit_caps_cached at 256x128 on the CPU: a miss fits and stores what
    fit_caps fits; a hit returns the same config without a stats frame."""
    monkeypatch.setattr(bench, "CAPS_CACHE_PATH", str(tmp_path / "caps.json"))
    monkeypatch.delenv("SC_BENCH_REFIT", raising=False)
    dev, build, config, env = headline_scene(256, 128, "cpu")
    state = build(0.0)
    fitted = fit_caps(dev, state, config, env)
    key = bench._caps_cache_key("headline", 256, 128, (HERO_GLB,) + bench.CAPS_SOURCES)
    assert bench.fit_caps_cached(dev, state, config, env, key) == fitted

    def no_fit(*a, **kw):
        raise AssertionError("a cache hit ran fit_caps")

    monkeypatch.setattr(bench, "fit_caps", no_fit)
    assert bench.fit_caps_cached(dev, state, config, env, key) == fitted
    assert fitted != config  # the stats frames did grow or tighten something


PRIMARY_KEYS = ("metric", "value", "unit", "vs_baseline", "device_frame_ms",
                "device_frame_spread", "device_frame_check_ms", "rtt_ms", "mpix_per_s",
                "device_busy_ms", "idle_share", "launches_per_frame", "correct", "device")


@pytest.fixture
def fake_card_clock(tmp_path, monkeypatch):
    """main's clock replaced by one FakeClock, each render_frame the bench
    times costing 5 ms on it; the caps cache in tmp_path; the bench's
    environment cleared."""
    clock = FakeClock()
    monkeypatch.setattr(bench, "HostClock", lambda device: clock)
    real = bench.render_frame

    def timed_frame(*a, **kw):
        clock.t += 0.005
        return real(*a, **kw)

    monkeypatch.setattr(bench, "render_frame", timed_frame)
    monkeypatch.setattr(bench, "CAPS_CACHE_PATH", str(tmp_path / "caps.json"))
    for var in ("SC_BENCH_BUDGET_S", "SC_BENCH_DEADLINE_S", "SC_BENCH_SAVE", "SC_BENCH_REFIT"):
        monkeypatch.delenv(var, raising=False)
    return clock


def _lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_main_on_the_cpu(fake_card_clock, capsys, monkeypatch, tmp_path):
    """main --device cpu at 256x128: the primary line first, then the line
    again as each configuration lands; the last has every key, the three
    configurations at 200 fps on the fake clock (5 ms a frame), correct,
    the CPU named as the device and no device busy time (no card to
    trace); the frames are written as PNGs."""
    monkeypatch.setenv("SC_BENCH_SAVE", str(tmp_path / "frame.png"))
    rc = bench.main(["--device", "cpu", "--width", "256", "--height", "128"])
    lines = _lines(capsys.readouterr().out)
    assert rc == 0
    first, last = lines[0], lines[-1]
    assert first["value"] == pytest.approx(200.0) and "all_passes_true_fps" not in first
    for key in PRIMARY_KEYS:
        assert key in last, key
    assert last["correct"] is True and last["device"] == {"platform": "cpu"}
    assert last["unit"] == "fps" and last["vs_baseline"] == pytest.approx(200.0 / 60, abs=1e-3)
    assert "256x128" in last["metric"]
    assert last["device_frame_ms"] == pytest.approx(5.0)
    assert last["rtt_ms"] == pytest.approx(BARRIER_S * 1e3)
    assert last["mpix_per_s"] == pytest.approx(256 * 128 / 5e-3 / 1e6, abs=0.01)
    assert last["device_busy_ms"] is None and last["idle_share"] is None
    assert last["all_passes_true_fps"] == pytest.approx(200.0)
    assert last["all_passes_device_frame_ms"] == pytest.approx(5.0)
    assert "sponza_cubes.glb" in last["all_passes_scene"]
    assert last["stereo_anim_true_fps"] == pytest.approx(200.0)
    assert last["stereo_anim_mpix_per_s"] == pytest.approx(2 * 256 * 128 / 5e-3 / 1e6, abs=0.01)
    assert last["stereo_anim_dispatch_fps"] > 0 and last["stereo_anim_dispatch_ms"] > 0
    for key in ("matmul_tflops_ceiling", "stream_gbps_ceiling", "gather_gbps_ceiling",
                "gather_mrows_per_s_ceiling"):
        assert key in last, key
    assert not [k for k in last if k.endswith("error")], last
    for name in ("frame.png", "frame_all.png"):
        with open(tmp_path / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_main_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code not in (0, None) and "CUDA" in str(e.value.code)


def test_a_wrong_frame_makes_main_exit_non_zero(fake_card_clock, capsys, monkeypatch):
    """A raster that drops one fragment (the timed path's only): the
    headline frame differs from its plain-versions twin, so the line says
    correct false, names the headline and holds no timed number of it, and
    main returns 1. The budget is 0 (nothing after the headline runs) and
    the deadline 0, so the watchdog's value-0 line comes first."""
    real = frame_mod.rasterize_sorted

    def drops_a_fragment(*a, **kw):
        vis = real(*a, **kw)
        pair = vis.pair.clone()
        pair.view(-1)[int(torch.nonzero(pair.view(-1) >= 0)[0])] = -1
        return vis._replace(pair=pair)

    monkeypatch.setattr(frame_mod, "rasterize_sorted", drops_a_fragment)
    monkeypatch.setenv("SC_BENCH_BUDGET_S", "0")
    monkeypatch.setenv("SC_BENCH_DEADLINE_S", "0")
    rc = bench.main(["--device", "cpu", "--width", "256", "--height", "128"])
    lines = _lines(capsys.readouterr().out)
    assert rc == 1
    assert lines[0]["value"] == 0.0 and "did not land" in lines[0]["error"]
    last = lines[-1]
    assert last["correct"] is False and last["incorrect"] == ["headline"]
    assert last["value"] == 0.0 and "differs" in last["error"]
    assert not [k for k in last if k.startswith("device_") or k.startswith("all_passes")]
    assert frame_mod.rasterize_sorted is drops_a_fragment  # the twin put it back


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_bench_imports_neither_jax_nor_the_jax_package():
    """Static: no import statement of jax, superconductor_tpu or the root
    bench in the bench or chip_smoke.py. At run time: importing the bench
    in a process where those raise loads none of them."""
    for path in (os.path.join(REPO, "superconductor_tpu_torch", "bench.py"),
                 os.path.join(REPO, "chip_smoke.py")):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "superconductor_tpu", "bench"), (path, name)
    child = textwrap.dedent(
        """
        import sys

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "superconductor_tpu", "bench"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Blocker())
        import superconductor_tpu_torch.bench
        bad = [m for m in ("jax", "superconductor_tpu", "bench") if m in sys.modules]
        print("loaded", bad)
        """
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", child], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "loaded []"
