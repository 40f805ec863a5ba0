"""Unit tests for the on-chip verification comparator (utils/verify.py).

The device run of `bench.py --verify` needs the GPU, but the comparison
semantics — set-IoU for compacted point
sets, count-within-2, angle-flip attribution, discrete/float leaf rules —
are pure host logic and are pinned here.
"""

import numpy as np

from mmwave_radar_processing_jax.utils.verify import (
    MIN_POINTS_IOU,
    compare_outputs,
)


def _points_case():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((4, 8, 4)).astype(np.float32)
    valid = np.ones((4, 8), bool)
    count = np.full(4, 8)
    return {"m/points": pts, "m/valid": valid, "m/count": count}


def test_identical_outputs_pass():
    o = _points_case()
    rep = compare_outputs(o, {k: v.copy() for k, v in o.items()})
    assert rep["ok"]
    leaves = {l["leaf"]: l for l in rep["leaves"]}
    assert leaves["m/points"]["set_iou_mean"] == 1.0
    assert leaves["m/count"]["agree_frac"] == 1.0


def test_single_flip_shifts_compaction_but_passes():
    """One dropped detection must read as a small set difference, not as a
    positional avalanche (the failure mode the set comparison exists for)."""
    o = _points_case()
    d = {k: v.copy() for k, v in o.items()}
    d["m/points"][0, 2:-1] = o["m/points"][0, 3:]  # drop det 2, shift rest
    d["m/valid"][0, -1] = False
    d["m/count"] = np.array([7, 8, 8, 8])
    rep = compare_outputs(o, d)
    leaves = {l["leaf"]: l for l in rep["leaves"]}
    assert rep["ok"]
    assert leaves["m/points"]["set_iou_mean"] > MIN_POINTS_IOU
    assert leaves["m/count"]["comparison"] == "count_within_2"
    # valid is informational (redundant with IoU + count), never gates
    assert leaves["m/valid"]["comparison"] == "informational"
    assert leaves["m/valid"]["ok"]


def test_angle_flip_attribution():
    """An unmatched pair sharing (range, vel) is counted as an angle flip."""
    o = _points_case()
    d = {k: v.copy() for k, v in o.items()}
    p = o["m/points"][1, 3]
    r = np.linalg.norm(p[:3])
    # same range & velocity, rotated into a different direction
    d["m/points"][1, 3] = [r, 0.0, 0.0, p[3]]
    rep = compare_outputs(o, d)
    leaves = {l["leaf"]: l for l in rep["leaves"]}
    assert leaves["m/points"]["angle_flip_frac"] > 0


def test_broken_kernel_fails_loudly():
    """A genuinely wrong device path (garbage points) must fail the gate."""
    o = _points_case()
    d = {k: v.copy() for k, v in o.items()}
    d["m/points"] = d["m/points"] + 10.0
    rep = compare_outputs(o, d)
    assert not rep["ok"]
    leaves = {l["leaf"]: l for l in rep["leaves"]}
    assert leaves["m/points"]["set_iou_mean"] == 0.0


def test_plain_leaf_rules():
    o = {"x/map": np.ones((4, 4), np.float32),
         "x/idx": np.arange(8)}
    d = {"x/map": np.ones((4, 4), np.float32) * 1.000001,
         "x/idx": np.arange(8)}
    rep = compare_outputs(o, d)
    assert rep["ok"]
    d["x/idx"] = np.arange(8)[::-1]
    rep = compare_outputs(o, d)
    assert not rep["ok"]


def test_f32_row_held_to_raised_gates():
    """pointcloud_f32 points/count leaves gate at 0.95, others at defaults.

    "ok" on the certified full-precision row must mean certification (IoU
    >= 0.95 mean, counts within-2 on >= 95% of frames), not the lower floor
    the TF32 rows use.
    """
    import numpy as np

    from mmwave_radar_processing_jax.utils import verify as v

    n = 16
    pts = np.zeros((n, 8, 4), np.float32)
    valid = np.zeros((n, 8), bool)
    valid[:, :3] = True
    pts[:, :3] = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    count = np.full(n, 3, np.int64)

    # a 0.94-class disagreement (15 of 16 frames): one frame's set differs
    pts_bad = pts.copy()
    pts_bad[0, :3] += 5.0
    oracle = {"pointcloud_f32/points": pts, "pointcloud_f32/valid": valid,
              "pointcloud_f32/count": count,
              "pointcloud/points": pts, "pointcloud/valid": valid,
              "pointcloud/count": count}
    device = dict(oracle, **{"pointcloud_f32/points": pts_bad,
                             "pointcloud/points": pts_bad})
    rep = v.compare_outputs(oracle, device)
    by_leaf = {l["leaf"]: l for l in rep["leaves"]}
    # same numerical disagreement: fast row passes its lower gate, the f32
    # row fails its raised 0.95 gate
    assert v.MIN_POINTS_IOU < 15 / 16 < 0.95
    assert by_leaf["pointcloud/points"]["ok"]
    assert by_leaf["pointcloud/points"]["gate"] == v.MIN_POINTS_IOU
    assert not by_leaf["pointcloud_f32/points"]["ok"]
    assert by_leaf["pointcloud_f32/points"]["gate"] == 0.95
    assert not rep["ok"]

    # count gate: off-by-1 everywhere -> f32 passes (within 2, 100%)
    device2 = dict(oracle)
    device2["pointcloud_f32/count"] = count + 1
    rep2 = v.compare_outputs(oracle, device2)
    by_leaf2 = {l["leaf"]: l for l in rep2["leaves"]}
    assert by_leaf2["pointcloud_f32/count"]["ok"]
    assert by_leaf2["pointcloud_f32/count"]["gate"] == 0.95


def test_every_metric_states_its_precision():
    from mmwave_radar_processing_jax.utils import verify as v

    assert set(v.METRIC_PRECISION) == set(v.VERIFY_METRICS)


def test_format_report_names_leaf_and_precision():
    from mmwave_radar_processing_jax.utils import verify as v

    o = {"pointcloud_f32/count": np.array([3, 4]),
         "velocity/vx": np.array([0.5, 0.25], np.float32)}
    rep = dict(v.compare_outputs(o, {k: x.copy() for k, x in o.items()}),
               device="test-device", batch=2)
    text = v.format_report(rep)
    assert text.splitlines()[0].startswith("verify on test-device")
    assert text.count("agree=1.00000") == 2
    assert v.METRIC_PRECISION["pointcloud_f32"] in text
    assert v.METRIC_PRECISION["velocity"] in text
    assert len(text.splitlines()) == 3
