"""Serving export of the port on the CPU: ``serving/export.py`` against
the JAX package's, the ``cl3d`` ops it captures, and its loader.

A port of ``tests/test_serving.py`` that goes further:

* the tiny flagship (``use_pallas="never"``, seeded BatchNorm statistics,
  ``test_torch_model.py``'s fixture) exported by both packages from the
  same weights: logits of the loaded artifacts within the tolerance of
  ``test_torch_model.py``, ``weights.npz`` equal key for key and bit for
  bit, ``meta.json`` equal on every shared key but ``platforms``;
* tiny models of the three tasks and of the other four operators, each
  exported with every family's plain version made to raise (so no plain
  version is traced), loaded back, and held to ``Predictor`` bit for bit;
  their graphs hold one ``cl3d`` node for each call the eager forward
  makes to that family; wrong shapes and other devices are refused;
* the loader imports no model code; ``torch.library.opcheck`` on every
  op; ``chip_smoke.plain_route`` still routes the ops.
"""

import contextlib
import json
import os
import subprocess
import sys
import types

import jax  # noqa: F401  (JAX on the CPU beside the port)
import numpy as np
import pytest
import torch

import chip_smoke
from closerlook3d_tpu.serving.export import export_forward as jexport_forward
from closerlook3d_tpu.serving.export import load_forward as jload_forward
from closerlook3d_tpu_torch.convert import flax_to_state_dict
from closerlook3d_tpu_torch.data.spatial_host import morton_sort_batch
from closerlook3d_tpu_torch.models import build_model
from closerlook3d_tpu_torch.ops import (
    aggregation, gather_reduce, grouping, moments, neighbors, pseudo_grid,
    sampling)
from closerlook3d_tpu_torch.serving import (
    Predictor, export_forward, load_forward)
from closerlook3d_tpu_torch.utils.config import Config, load_config
from test_torch_model import flagship  # noqa: F401  (module fixture)
from test_torch_ops import _one_aten_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each op of the cl3d namespace and the plain versions its
# implementation runs on CPU tensors
FAMILIES = {
    "ball_query": [(neighbors, "ball_query_plain")],
    "furthest_point_sample": [(sampling, "furthest_point_sample_plain")],
    "pospool": [(aggregation, "pospool_xyz_plain"),
                (aggregation, "pospool_sincos_plain")],
    "neighborhood_max": [(grouping, "neighborhood_max_plain")],
    "neighborhood_moments": [(moments, "neighborhood_moments_plain")],
    "gather_sub_minmax": [(gather_reduce, "gather_sub_minmax_plain")],
    "pseudo_grid": [(pseudo_grid, "pseudo_grid_plain")],
    "knn": [(neighbors, "knn_plain")],
    "grid_subsample": [(sampling, "grid_subsample_plain")],
}


@contextlib.contextmanager
def _plain_versions(wrap):
    """Every family's plain version replaced by ``wrap(family, fn)``."""
    saved = [(m, name, getattr(m, name))
             for places in FAMILIES.values() for m, name in places]
    try:
        for fam, places in FAMILIES.items():
            for m, name in places:
                setattr(m, name, wrap(fam, getattr(m, name)))
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _counting(counts):
    def wrap(fam, fn):
        def counted(*a, **k):
            counts[fam] = counts.get(fam, 0) + 1
            return fn(*a, **k)
        return counted
    return wrap


def _refusing(fam, fn):
    def refuse(*a, **k):
        raise AssertionError(f"the plain version of {fam} was traced")
    return refuse


def graph_ops(program) -> dict:
    """{family: cl3d nodes} of an exported program's graph."""
    out = {}
    for node in program.graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith("cl3d."):
            fam = target.split(".")[1]
            out[fam] = out.get(fam, 0) + 1
    return out


# ---- the JAX package's artifact and the port's, from the same weights ------

@pytest.fixture(scope="module")
def both_artifacts(flagship, tmp_path_factory):  # noqa: F811
    """(JAX dir, port dir, JAX logits, port logits, batch)."""
    jcfg, cfg, variables, batch, _ = flagship
    nb = len(batch["xyz"])
    jcfg = jcfg.copy_and_resolve_references()
    jcfg.batch_size = nb
    root = tmp_path_factory.mktemp("artifacts")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jexport_forward(jcfg, types.SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"]),
        jdir)
    jpredictor, _ = jload_forward(jdir)
    args = (batch["xyz"], batch["mask"], batch["features"])
    jlogits = np.asarray(jpredictor(*args))
    cfg = Config(cfg.to_dict(), batch_size=nb)
    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables, model))
    export_forward(cfg, model, tdir)
    predictor, _ = load_forward(tdir, device="cpu")
    return jdir, tdir, jlogits, predictor(*args).numpy(), batch


def test_artifact_logits_match_jax(both_artifacts):
    _, _, jlogits, logits, batch = both_artifacts
    assert logits.shape == jlogits.shape == (len(batch["xyz"]), 8)
    assert logits.dtype == np.float32
    # f32 end to end; matmul and reduction orders differ between XLA and
    # ATen on the CPU (test_torch_model.py's tolerance)
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-5)


def test_artifact_weights_equal_jax(both_artifacts):
    jdir, tdir = both_artifacts[:2]
    with np.load(os.path.join(jdir, "weights.npz")) as jz, \
            np.load(os.path.join(tdir, "weights.npz")) as tz:
        assert sorted(tz.files) == sorted(jz.files)
        for k in jz.files:
            assert tz[k].dtype == jz[k].dtype, k
            np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)


def test_artifact_meta_matches_jax(both_artifacts):
    jdir, tdir = both_artifacts[:2]
    metas = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "meta.json")) as f:
            metas.append(json.load(f))
    jmeta, meta = metas
    shared = (set(jmeta) & set(meta)) - {"platforms"}
    assert shared == {"batch_size", "num_points", "feature_dim",
                      "num_outputs", "task", "local_aggregation_type"}
    assert {k: meta[k] for k in shared} == {k: jmeta[k] for k in shared}
    assert meta["platforms"] == ["cpu"]
    assert meta["torch_version"] == torch.__version__


# ---- the three tasks and the other operators, against Predictor -------------

def tiny_config(name: str) -> Config:
    """Tiny f32 models: "cls" (PosPool xyz), "partseg", "scene" (grid
    sampling, ``ones,rgb,height``), and classification with "sincos",
    "adaptive", "pwmlp" or "pgrid" aggregation."""
    cfg = load_config()
    cfg.update(num_points=64, num_classes=8, width=24, depth=1,
               nsamples=[8, 8, 8], radius=0.4, precision="f32",
               cls_head_dims=[32, 16], batch_size=4, npoints=[])
    if name == "partseg":
        cfg.update(task="part_segmentation", datasets="shapenetpart",
                   num_classes=16)
    elif name == "scene":
        cfg.update(task="scene_segmentation", sampling="grid", sampleDl=0.2,
                   num_classes=4, input_features="ones,rgb,height")
    elif name == "sincos":
        cfg.pospool.position_embedding = "sin_cos"
    elif name == "adaptive":
        cfg.local_aggregation_type = "adaptive_weight"
        cfg.adaptive_weight.update(local_input_feature="dp", fc_num=1,
                                   reduction="avg")
    elif name == "pwmlp":
        cfg.local_aggregation_type = "pointwisemlp"
        cfg.pointwisemlp.update(feature_type="dp_fi_df", num_mlps=1,
                                reduction="max")
    elif name == "pgrid":
        cfg.local_aggregation_type = "pseudo_grid"
        cfg.pseudo_grid.update(num_kernel_points=15, KP_influence="linear",
                               KP_extent=1.0, convolution_mode="sum")
    return cfg


def tiny_batch(cfg, seed: int, padded: bool) -> dict:
    from closerlook3d_tpu_torch.data.loader import feature_dim

    rng = np.random.default_rng(seed)
    nb, n = cfg.batch_size, cfg.num_points
    xyz = rng.uniform(-1, 1, (nb, n, 3)).astype(np.float32)
    mask = np.ones((nb, n), bool)
    if padded:
        mask[1, n // 2:] = False
        mask[-1, 10:] = False
    feats = rng.normal(size=(nb, n, feature_dim(cfg.input_features)))
    return morton_sort_batch({"xyz": xyz, "mask": mask,
                              "features": feats.astype(np.float32)})


TINY = ("cls", "partseg", "scene", "sincos", "adaptive", "pwmlp", "pgrid")
# the families each tiny model must reach
REACHES = {"cls": ("ball_query", "furthest_point_sample", "pospool",
                   "neighborhood_max"),
           "partseg": ("knn",), "scene": ("grid_subsample", "knn"),
           "sincos": ("pospool",), "adaptive": ("neighborhood_moments",),
           "pwmlp": ("gather_sub_minmax",), "pgrid": ("pseudo_grid",)}


@pytest.fixture(scope="module", params=TINY)
def exported(request, tmp_path_factory):
    """(name, cfg, Predictor, loaded artifact, meta, eager calls by
    family, batches)."""
    name = request.param
    cfg = tiny_config(name)
    weights = chip_smoke.seeded_weights(
        cfg, torch.Generator().manual_seed(TINY.index(name)))
    predictor = Predictor(cfg, weights, device="cpu")
    batches = [tiny_batch(cfg, 40 + i, padded=i == 1) for i in range(2)]
    calls = {}
    with _plain_versions(_counting(calls)):
        predictor(batches[0]["xyz"], batches[0]["mask"],
                  batches[0]["features"])
    out = str(tmp_path_factory.mktemp(name) / "artifact")
    with _plain_versions(_refusing):
        export_forward(cfg, predictor.model, out)
    artifact, meta = load_forward(out, device="cpu")
    return name, cfg, predictor, artifact, meta, calls, batches, out


def test_artifact_equals_predictor(exported):
    name, cfg, predictor, artifact, meta, _, batches, _ = exported
    assert meta["task"] == cfg.task and meta["platforms"] == ["cpu"]
    for bt in batches:
        args = (bt["xyz"], bt["mask"], bt["features"])
        got, want = artifact(*args), predictor(*args)
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        width = want.shape[-1]
        shape = ((cfg.batch_size, width) if cfg.task == "classification"
                 else (cfg.batch_size, cfg.num_points, width))
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_graph_holds_one_op_per_eager_call(exported):
    name, _, _, artifact, _, calls, _, _ = exported
    assert graph_ops(artifact._forward) == calls
    assert set(REACHES[name]) <= set(calls)


def test_artifact_refuses_wrong_shapes(exported):
    _, cfg, _, artifact, _, _, batches, _ = exported
    bt = batches[0]
    half = cfg.num_points // 2
    with pytest.raises(ValueError, match="differ from the exported"):
        artifact(bt["xyz"][:, :half], bt["mask"][:, :half],
                 bt["features"][:, :half])
    with pytest.raises(ValueError, match="differ from the exported"):
        artifact(bt["xyz"][:2], bt["mask"][:2], bt["features"][:2])
    # the exported program itself holds its input shapes
    with pytest.raises(Exception):
        artifact._forward(torch.from_numpy(bt["xyz"][:, :half]),
                          torch.from_numpy(bt["mask"][:, :half]),
                          torch.from_numpy(bt["features"][:, :half]))


@pytest.mark.parametrize("exported", ["cls"], indirect=True)
def test_artifact_is_pinned_to_its_device(exported):
    out = exported[-1]
    with pytest.raises(ValueError, match="exported for 'cpu'"):
        load_forward(out, device="cuda")
    assert load_forward(out)[1]["platforms"] == ["cpu"]


@pytest.mark.parametrize("exported", ["cls"], indirect=True)
def test_loaded_program_drops_metadata_asserts(exported):
    """``load_forward`` drops the ``_assert_tensor_metadata`` nodes of the
    saved program; the two serve the same logits."""
    _, _, _, artifact, _, _, batches, out = exported
    kept = torch.export.load(os.path.join(out, "forward.pt2")).module()

    def asserts(module):
        return sum(1 for n in module.graph.nodes
                   if "_assert_tensor_metadata" in str(n.target))

    assert asserts(kept) > 0 and asserts(artifact._forward) == 0
    bt = batches[1]
    args = [torch.from_numpy(bt[k]) for k in ("xyz", "mask", "features")]
    with torch.inference_mode():
        want = kept(*args)
    np.testing.assert_array_equal(artifact(*args).numpy(), want.numpy())


@pytest.mark.parametrize("exported", ["scene"], indirect=True)
def test_loader_imports_no_model_code(exported):
    _, _, predictor, _, _, _, batches, out = exported
    bt = batches[1]
    path = os.path.join(os.path.dirname(out), "batch.npz")
    np.savez(path, **bt)
    code = (
        "import sys, numpy as np, torch\n"
        "from closerlook3d_tpu_torch.serving import load_forward\n"
        f"predictor, meta = load_forward({out!r}, device='cpu')\n"
        f"bt = np.load({path!r})\n"
        "out = predictor(bt['xyz'], bt['mask'], bt['features'])\n"
        f"np.save({path!r} + '.out.npy', out.numpy())\n"
        "port = 'closerlook3d_tpu_torch.'\n"
        "bad = [m for m in sys.modules if m.startswith((port + 'models',\n"
        "    port + 'convert', port + 'train', 'jax', 'closerlook3d_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    want = predictor(bt["xyz"], bt["mask"], bt["features"]).numpy()
    np.testing.assert_array_equal(np.load(path + ".out.npy"), want)


# ---- the ops: schemas, fake implementations, routing ------------------------

def _op_cases():
    """(op name, arguments) at small shapes, on the CPU."""
    g = torch.Generator().manual_seed(3)
    b, n, nq, k, c = 2, 40, 12, 6, 12
    s = torch.rand((b, n, 3), generator=g)
    q = s[:, :nq].contiguous()
    smask = torch.ones((b, n), dtype=torch.bool)
    smask[1, 30:] = False
    qmask = smask[:, :nq].contiguous()
    idx, nmask = neighbors.ball_query(q, s, 0.4, k, qmask, smask)
    f = torch.randn((b, n, c), generator=g)
    d = torch.randn((b, nq, c), generator=g)
    kp = torch.rand((5, 3), generator=g) - 0.5
    return [
        ("ball_query", (q, s, 0.4, k, qmask, smask, None)),
        ("ball_query", (q, s, 0.4, k, None, None, 4)),
        ("furthest_point_sample", (s, nq, smask)),
        ("pospool", (q, s, f, idx, nmask, 0.4, "xyz", "avg")),
        ("pospool", (q, s, f.bfloat16(), idx, nmask, 0.4, "sin_cos",
                     "sum")),
        ("neighborhood_max", (f, idx, nmask)),
        ("neighborhood_max", (f.bfloat16(), idx, None)),
        ("neighborhood_moments", (q, s, f, idx, nmask, 0.4, "avg")),
        ("gather_sub_minmax", (f, d, idx, nmask)),
        ("pseudo_grid", (q, s, f, idx, nmask, kp, 0.4, 0.5, "linear")),
        ("knn", (q, s, 3, smask, None)),
        ("knn", (q, s, 50, None, None)),  # k > Ns pads
        ("grid_subsample", (s, 0.3, 16, smask)),
    ]


@pytest.mark.parametrize("case", range(len(_op_cases())))
def test_opcheck(case):
    name, args = _op_cases()[case]
    op = getattr(torch.ops.cl3d, name).default
    torch.library.opcheck(op, args, test_utils=(
        "test_schema", "test_faketensor", "test_autograd_registration"))


def test_every_family_is_an_op():
    for fam in FAMILIES:
        assert hasattr(torch.ops.cl3d, fam), fam


def test_ops_read_use_kernel_at_call_time(monkeypatch):
    """An op's implementation dispatches through its module's
    ``use_kernel`` as it stands at the call: told that a CPU tensor is a
    CUDA one, it calls the kernel's wrapper (here a counting stand-in);
    inside ``chip_smoke.plain_route`` the plain version again. Where grad
    is on, the differentiable families reach the op through their
    ``autograd.Function``."""
    launched = []
    monkeypatch.setattr(grouping, "use_kernel", lambda t: True)
    monkeypatch.setattr(
        grouping, "neighborhood_max_cuda",
        lambda f, i, m: launched.append(1) or grouping.neighborhood_max_plain(
            f, i, m))
    f = torch.randn((2, 30, 6))
    idx = torch.randint(0, 30, (2, 10, 4), dtype=torch.int32)
    mask = torch.rand((2, 10, 4)) > 0.3
    want = grouping.neighborhood_max_plain(f, idx, mask)
    with torch.no_grad():
        assert torch.equal(grouping.neighborhood_max(f, idx, mask), want)
    assert len(launched) == 1
    with torch.no_grad(), chip_smoke.plain_route():
        assert torch.equal(grouping.neighborhood_max(f, idx, mask), want)
    assert len(launched) == 1
    fg = f.clone().requires_grad_()
    assert torch.equal(grouping.neighborhood_max(fg, idx, mask), want)
    assert len(launched) == 2
    with chip_smoke.plain_route():
        out = grouping.neighborhood_max(fg, idx, mask)
    assert len(launched) == 2 and out.grad_fn is not None
