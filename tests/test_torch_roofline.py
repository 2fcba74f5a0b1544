"""The port's ceiling probes (utils/roofline.py) on the CPU at small sizes:
each probe's FLOP and byte counts from its shapes, the result's keys, the
prediction band against the reference's predict_ms, and the refusal to
measure a card that is not there. The card's numbers come only from a run
on it (chip_smoke.py, phase roofline); no timing is asserted here."""

import pytest
import torch

from superconductor_tpu.utils import roofline as ref_roofline
from superconductor_tpu_torch.utils import roofline

torch.set_num_threads(2)

SMALL = {"matmul": (2, 64), "stream": (3, 1 << 12), "gather": (2, 1 << 10, 8, 1 << 9)}


def test_probe_ceilings_counts_each_probes_work():
    out = roofline.probe_ceilings(ns=(1, 2), calls=1, device="cpu", sizes=SMALL)
    assert out["device"] == "cpu"
    assert {"matmul_tflops", "stream_gbps", "gather_gbps", "gather_mrows_per_s",
            "dispatch_floor_ms"} <= set(out)
    p = out["probes"]
    assert p["matmul"]["flops"] == 2.0 * 2 * 64 ** 3
    assert p["stream"]["bytes"] == 2.0 * 3 * (1 << 12) * 4
    assert p["gather"]["bytes"] == 2.0 * 2 * (1 << 9) * 8 * 4
    for name in ("matmul", "stream", "gather", "floor"):
        assert len(p[name]["check_ms"]) == 1


@pytest.mark.parametrize("flops, bytes_", [(0.0, 1e9), (1e12, 1e6), (5e11, 3e9)])
def test_predict_ms_matches_reference(flops, bytes_):
    ceilings = {"matmul_tflops": 600.0, "stream_gbps": 3000.0, "gather_gbps": 400.0}
    assert roofline.predict_ms(flops, bytes_, ceilings) == ref_roofline.predict_ms(
        flops, bytes_, ceilings)


def test_probe_ceilings_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        roofline.probe_ceilings(device="cuda")
