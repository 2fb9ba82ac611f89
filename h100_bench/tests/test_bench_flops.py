"""The yardstick's arithmetic against hand counts on a small network:
3 stages of 8, 4 and 2 points, widths 6, 12, 24, one block a stage."""

import pytest

from h100_bench import flops

CFG = {"nsamples": [2, 2, 2], "npoints": [8, 4, 2], "num_points": 8,
       "radius": 0.1, "width": 6, "depth": 1, "bottleneck_ratio": 2,
       "input_features": "xyz", "num_parts": [3],
       "local_aggregation_type": "pospool", "precision": "bf16"}
CENSUS = {"clouds": 1, "points": [8, 4, 2], "valid": [8, 4, 2],
          "valid_per_cloud": [[8], [4], [2]], "pairs": [20, 9, 7, 4, 5],
          "slots": {"0": (10, 2), "s1": (6, 2), "1": (5, 2), "s2": (3, 2),
                    "2": (4, 2)}}
HBM, F32 = 3.35e12, 67e12

# rows x in x out of every matmul of one forward, written out by hand
MATMULS = [8 * 3 * 3,                                  # stem
           8 * 3 * 3, 8 * 3 * 6, 8 * 3 * 6,            # block 0
           8 * 6 * 6, 4 * 6 * 12, 4 * 6 * 12,         # stage 1, strided
           4 * 12 * 6, 4 * 6 * 12,                     # stage 1
           4 * 12 * 12, 2 * 12 * 24, 2 * 12 * 24,      # stage 2, strided
           2 * 24 * 12, 2 * 12 * 24,                   # stage 2
           4 * 36 * 12, 8 * 18 * 6,                    # decoder
           8 * 6 * 6, 8 * 6 * 3]                       # head conv, fc
# (valid slots, channels) of each PosPool call, and of each strided max
POSPOOL = [(10, 3), (10, 3), (6, 6), (5, 6), (3, 12), (4, 12)]
MAXES = [(6, 6), (3, 12)]


def test_eval_forward_operations():
    expect = (2 * sum(MATMULS) + sum(s * (6 + 2 * c) for s, c in POSPOOL)
              + sum(s * c for s, c in MAXES))
    assert flops.model_flops(CFG, CENSUS, train=False) == expect == 16272


def test_train_step_operations():
    # the stem's input carries no gradient: 2 products, the rest 3
    mm = 2 * 2 * MATMULS[0] + 3 * 2 * sum(MATMULS[1:])
    agg = 2 * sum(s * (6 + 2 * c) for s, c in POSPOOL)
    mx = sum(s * c * (1 + 2) for s, c in MAXES)
    assert flops.model_flops(CFG, CENSUS, train=True) == mm + agg + mx


def test_aggregation_least_time_eval():
    # (bytes, operations): features in and out at 2 bytes, 5 bytes a
    # slot, 12 bytes a query and support point
    calls = [(368, 120), (368, 120), (328, 108), (184, 36), (232, 90),
             (236, 90), (164, 36), (164, 120)]
    expect = sum(max(b / HBM, o / F32) for b, o in calls)
    assert flops.aggregation_least_s(CFG, CENSUS, train=False) == \
        pytest.approx(expect, rel=1e-12)


def test_geometry_least_time():
    bq = [((8 + 8) * 13 + 8 * 2 * 5, 8 * 20), ((4 + 8) * 13 + 4 * 2 * 5, 8 * 9),
          ((4 + 4) * 13 + 4 * 2 * 5, 8 * 7), ((2 + 4) * 13 + 2 * 2 * 5, 8 * 4),
          ((2 + 2) * 13 + 2 * 2 * 5, 8 * 5)]
    fps = [(8 * 13 + 4 * 5, 9 * 4 * 8), (4 * 13 + 2 * 5, 9 * 2 * 4)]
    knn = [((8 + 4) * 12 + 4 + 8 * 8, 0), ((4 + 2) * 12 + 2 + 4 * 8, 0)]
    expect = sum(max(b / HBM, o / F32) for b, o in bq + fps + knn)
    assert flops.geometry_least_s(CFG, CENSUS) == pytest.approx(expect,
                                                                rel=1e-12)


def test_point_wise_mlp_counts_its_projections():
    cfg = {**CFG, "local_aggregation_type": "pointwisemlp"}
    base = 2 * sum(MATMULS)
    proj = 0
    calls = [("0", 8, 8, 3), ("0", 8, 8, 3), ("s1", 4, 8, 6), ("1", 4, 4, 6),
             ("s2", 2, 4, 12), ("2", 2, 2, 12)]
    for _, nq, ns, c in calls:  # C out = C in
        proj += 2 * (ns * 3 * c + ns * 2 * c * c + nq * 3 * c + nq * c * c)
    slots = sum(CENSUS["slots"][k][0] * c * 3 for k, _, _, c in calls)
    mx = sum(s * c for s, c in MAXES)
    assert flops.model_flops(cfg, CENSUS, train=False) == \
        base + proj + slots + mx
