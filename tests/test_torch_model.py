"""Port model and serving path (CPU, plain versions) vs the JAX package.

One tiny flagship model (``__graft_entry__._flagship_cfg(tiny=True)``,
f32, ``use_pallas="never"``) is initialised in flax, given seeded
non-trivial BatchNorm statistics, converted with the weight bridge, and
run by both packages on the same numpy batch.
"""

import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from closerlook3d_tpu.data import spatial_host as jspatial
from closerlook3d_tpu.data import synthetic as jsynthetic
from closerlook3d_tpu.models import build_model as jbuild_model
from closerlook3d_tpu.models.backbone import (
    compute_geometry as jcompute_geometry)
from closerlook3d_tpu.utils.config import default_config as jdefault_config
from closerlook3d_tpu.utils.config import load_config as jload_config
from closerlook3d_tpu_torch.convert import (
    flatten_variables, flax_to_state_dict, state_dict_to_flax)
from closerlook3d_tpu_torch.data import spatial_host, synthetic
from closerlook3d_tpu_torch.models import build_model
from closerlook3d_tpu_torch.models.backbone import compute_geometry
from closerlook3d_tpu_torch.serving import Predictor
from closerlook3d_tpu_torch.utils.config import (
    Config, default_config, load_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def flagship():
    """(jax cfg, port cfg, flax variables, batch, jax logits)."""
    jcfg = graft._flagship_cfg(tiny=True)
    jcfg.use_pallas = "never"
    cfg = Config(jcfg.to_dict())
    rng = np.random.default_rng(5)
    b, n = 4, jcfg.num_points
    xyz = rng.uniform(-1, 1, size=(b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 40:] = False  # a padded cloud
    batch = jspatial.morton_sort_batch(
        {"xyz": xyz, "mask": mask, "features": xyz.copy()})

    model, _ = jbuild_model(jcfg)
    args = (batch["xyz"], batch["mask"], batch["features"])
    variables = jax.jit(lambda r: model.init(r, *args, train=False))(
        jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, dict(variables))
    # non-trivial BN: seeded running stats and affine params
    flat = flatten_variables(variables)
    for k in sorted(flat):
        shape = flat[k].shape
        if k.endswith("/mean") or k.endswith("/bias"):
            flat[k] = rng.normal(0, 0.2, shape).astype(np.float32)
        elif k.endswith("/var") or k.endswith("/scale"):
            flat[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    nested = {}
    for k, v in flat.items():
        node = nested
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    logits = jax.jit(lambda v, *a: model.apply(v, *a, train=False))(
        nested, *args)
    return jcfg, cfg, nested, batch, np.asarray(logits)


@pytest.mark.parametrize("path", [
    None, "configs/modelnet40/pospool_xyz_avg.yaml",
    "configs/s3dis/pospool_xyz_avg.yaml",
    "configs/modelnet40/pospool_sincos_avg.yaml",
    "configs/modelnet40/adaptive_weight_dp_fc1_avg.yaml"])
def test_config_matches_jax(path):
    if path is None:
        assert default_config().to_dict() == jdefault_config().to_dict()
        return
    path = os.path.join(REPO, path)
    assert load_config(path).to_dict() == jload_config(path).to_dict()


def test_weight_bridge_round_trips(flagship):
    _, cfg, variables, _, _ = flagship
    model = build_model(cfg)
    state = flax_to_state_dict(variables, model)
    model.load_state_dict(state, strict=True)
    back = state_dict_to_flax(model.state_dict(), model)
    flat = flatten_variables(variables)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_weight_bridge_rejects_unknown_and_missing_keys(flagship):
    _, cfg, variables, _, _ = flagship
    model = build_model(cfg)
    flat = flatten_variables(variables)
    extra = dict(flat)
    extra["params/ResNetBackbone_0/Extra_0/kernel"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="no counterpart"):
        flax_to_state_dict(extra, model)
    missing = dict(flat)
    del missing["batch_stats/ClassifierHead_0/ConvBN_0/BatchNorm_0/var"]
    with pytest.raises(KeyError, match="missing"):
        flax_to_state_dict(missing, model)
    state = flax_to_state_dict(flat, model)
    state["head.extra"] = torch.zeros(1)
    with pytest.raises(KeyError, match="no flax counterpart"):
        state_dict_to_flax(state, model)


def test_compute_geometry_matches_jax(flagship):
    jcfg, cfg, _, batch, _ = flagship
    jg = jcompute_geometry(jcfg, batch["xyz"], batch["mask"])
    tg = compute_geometry(cfg, torch.from_numpy(batch["xyz"]),
                          torch.from_numpy(batch["mask"]))
    assert sorted(tg) == sorted(jg)
    for k in jg:
        assert tg[k].dtype == {np.dtype(np.float32): torch.float32,
                               np.dtype(np.int32): torch.int32,
                               np.dtype(bool): torch.bool}[
                                   np.asarray(jg[k]).dtype], k
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]),
                                      err_msg=k)


def test_eval_logits_match_jax(flagship):
    _, cfg, variables, batch, jlogits = flagship
    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables, model))
    with torch.inference_mode():
        logits = model(torch.from_numpy(batch["xyz"]),
                       torch.from_numpy(batch["mask"]),
                       torch.from_numpy(batch["features"]))
    assert logits.shape == (4, cfg.num_classes)
    assert logits.dtype == torch.float32
    # f32 end to end; matmul and reduction orders differ between XLA and
    # ATen on the CPU
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-4, atol=1e-5)


def test_predictor_serves_export_forward_weights(flagship, tmp_path):
    from closerlook3d_tpu.serving.export import export_forward

    jcfg, cfg, variables, batch, jlogits = flagship
    jcfg = jcfg.copy_and_resolve_references()
    jcfg.batch_size = 4
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    export_forward(jcfg, state, str(tmp_path))
    predictor = Predictor(cfg, str(tmp_path / "weights.npz"), device="cpu")
    logits = predictor(batch["xyz"], batch["mask"], batch["features"])
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-4, atol=1e-5)
    # a port state_dict serves the same logits
    again = Predictor(cfg, predictor.model.state_dict(), device="cpu")
    np.testing.assert_array_equal(
        again(batch["xyz"], batch["mask"], batch["features"]).numpy(),
        logits.numpy())


def test_port_imports_no_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "import closerlook3d_tpu_torch\n"
        "from closerlook3d_tpu_torch.utils.config import load_config\n"
        "from closerlook3d_tpu_torch.serving import Predictor\n"
        "from closerlook3d_tpu_torch.models import build_classification\n"
        "from closerlook3d_tpu_torch.train import (create_train_state,\n"
        "    make_eval_step, make_optimizer, make_train_step)\n"
        "from closerlook3d_tpu_torch.data.loader import BatchIterator\n"
        "from closerlook3d_tpu_torch.data.synthetic import (\n"
        "    SyntheticClassification)\n"
        "cfg = load_config()\n"
        "cfg.update(num_points=64, num_classes=8, width=24, depth=1,\n"
        "           nsamples=[8, 8, 8], radius=0.4, precision='f32',\n"
        "           cls_head_dims=[32, 16], batch_size=2)\n"
        "model, loss_fn = build_classification(cfg)\n"
        "state = create_train_state(model, make_optimizer(cfg, 4)[0],\n"
        "                           device='cpu')\n"
        "batch = next(iter(BatchIterator(SyntheticClassification(4, 64),\n"
        "                                2, True, 'xyz', spatial_sort=True)))\n"
        "state, m = make_train_step(loss_fn, cfg.task)(state, batch, 0)\n"
        "assert torch.isfinite(m['loss'])\n"
        "make_eval_step(loss_fn, cfg.task)(state, batch)\n"
        "p = Predictor(cfg, state.model.state_dict(), device='cpu')\n"
        "x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 3))\n"
        "out = p(x, np.ones((2, 64), bool), x)\n"
        "assert out.shape == (2, 8) and torch.isfinite(out).all()\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'ml_collections',\n"
        "                   'closerlook3d_tpu') if m in sys.modules]\n"
        "bad += [m for m in sys.modules\n"
        "        if m.startswith(('jax.', 'flax.', 'optax.',\n"
        "                         'closerlook3d_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_morton_sort_batch_copy_matches_original():
    rng = np.random.default_rng(8)
    xyz = rng.normal(size=(3, 200, 3)).astype(np.float32)
    mask = rng.random((3, 200)) > 0.2
    batch = {"xyz": xyz, "mask": mask, "features": xyz * 2,
             "label": np.arange(3, dtype=np.int32)}
    np.testing.assert_array_equal(spatial_host.morton_keys_np(xyz, mask),
                                  jspatial.morton_keys_np(xyz, mask))
    got = spatial_host.morton_sort_batch(batch)
    ref = jspatial.morton_sort_batch(batch)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("augment", [False, True])
def test_synthetic_shapes_copy_matches_original(augment):
    got = synthetic.SyntheticClassification(8, 128, seed=3, augment=augment)
    ref = jsynthetic.SyntheticClassification(8, 128, seed=3, augment=augment)
    for i in range(8):  # one sample of every shape family
        a, b = got[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i}/{k}")
