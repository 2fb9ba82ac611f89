"""On-disk data validation, the ``--check_data`` mode of ``cli/train.py``
(``closerlook3d_tpu/data/check.py``, with the same messages).

For each dataset's distribution (ModelNet40's resampled txt tree,
ShapeNetPart's synset dirs and json splits, PartNet's ``sem_seg_h5``,
S3DIS's raw Annotations or its processed cache) it reports the expected
tree, what is present and whether a sample parses, before a training run
would fail on it. Each check appends (level, message) findings, level in
{"ok", "warn", "error"}; the CLI exits non-zero on any error. ``h5py`` is
imported by the PartNet check alone.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

# official split sizes — mismatches are warnings (subsets are common)
_MN40_EXPECTED = {"train": 9843, "test": 2468}
_SHAPENET_EXPECTED = {"train": 12137, "val": 1870, "test": 2874}


class Report:
    def __init__(self):
        self.findings = []

    def ok(self, msg):
        self.findings.append(("ok", msg))

    def warn(self, msg):
        self.findings.append(("warn", msg))

    def error(self, msg):
        self.findings.append(("error", msg))

    @property
    def has_errors(self):
        return any(lv == "error" for lv, _ in self.findings)

    def render(self):
        mark = {"ok": "  OK ", "warn": "WARN ", "error": " ERR "}
        return "\n".join(f"[{mark[lv]}] {msg}" for lv, msg in self.findings)


def _check_finite(rep, arr, what):
    if not np.all(np.isfinite(arr)):
        rep.error(f"{what}: contains non-finite values")
        return False
    return True


def check_modelnet40(cfg, rep: Report):
    root = os.path.join(cfg.data_root, "modelnet40_normal_resampled")
    if not os.path.isdir(root):
        rep.error(
            f"ModelNet40 root missing: {root} — expected the "
            "'modelnet40_normal_resampled' distribution (per-shape txt of "
            "10k points+normals). Set cfg.data_root to its parent dir.")
        return
    rep.ok(f"root: {root}")
    for split, expected in _MN40_EXPECTED.items():
        lf = os.path.join(root, f"modelnet40_{split}.txt")
        if not os.path.exists(lf):
            rep.error(f"split list missing: {lf}")
            continue
        with open(lf) as f:
            ids = [ln.strip() for ln in f if ln.strip()]
        if len(ids) != expected:
            rep.warn(f"{split} split lists {len(ids)} shapes "
                     f"(official: {expected})")
        else:
            rep.ok(f"{split} split: {len(ids)} shapes")
        missing = 0
        for sid in ids:
            cls = "_".join(sid.split("_")[:-1])
            base = os.path.join(root, cls, sid)
            if not (os.path.exists(base + ".txt")
                    or os.path.exists(base + ".npy")):
                missing += 1
                if missing <= 3:
                    rep.error(f"shape file missing: {base}.txt")
        if missing > 3:
            rep.error(f"... and {missing - 3} more missing {split} shapes")
        if ids and not missing:
            sid = ids[0]
            cls = "_".join(sid.split("_")[:-1])
            try:
                pts = np.loadtxt(os.path.join(root, cls, sid + ".txt"),
                                 delimiter=",", max_rows=32)
            except Exception as e:  # noqa: BLE001 — report any parse error
                rep.error(f"sample parse failed ({sid}.txt): {e} — "
                          "expected comma-separated 'x,y,z,nx,ny,nz' rows")
                continue
            if pts.ndim != 2 or pts.shape[1] != 6:
                rep.error(f"sample {sid}.txt has shape {pts.shape}; "
                          "expected [*, 6] (xyz + normals)")
            elif _check_finite(rep, pts, f"sample {sid}.txt"):
                rep.ok(f"parsed sample {sid}.txt: [*, 6], finite")


def check_shapenetpart(cfg, rep: Report):
    from closerlook3d_tpu_torch.data.shapenetpart import CATEGORIES
    root = os.path.join(
        cfg.data_root,
        "shapenetcore_partanno_segmentation_benchmark_v0_normal")
    if not os.path.isdir(root):
        rep.error(
            f"ShapeNetPart root missing: {root} — expected the "
            "'..._v0_normal' distribution (synset dirs of txt + "
            "train_test_split/*.json)")
        return
    rep.ok(f"root: {root}")
    absent = [s for _, s, _ in CATEGORIES
              if not os.path.isdir(os.path.join(root, s))]
    if absent:
        # only a warning: files the splits actually reference are
        # checked below and error there if missing
        rep.warn(f"{len(absent)}/16 synset dirs absent "
                 f"(e.g. {absent[0]}) — subset distribution?")
    else:
        rep.ok("all 16 synset dirs present")
    sample_done = False
    for split, expected in _SHAPENET_EXPECTED.items():
        jf = os.path.join(root, "train_test_split",
                          f"shuffled_{split}_file_list.json")
        if not os.path.exists(jf):
            rep.error(f"split json missing: {jf}")
            continue
        with open(jf) as f:
            try:
                tokens = json.load(f)
            except json.JSONDecodeError as e:
                rep.error(f"split json unparseable: {jf}: {e}")
                continue
        bad = [t for t in tokens[:64] if len(t.split("/")) != 3]
        if bad:
            rep.error(f"{jf}: tokens not 'shape_data/<synset>/<id>' "
                      f"(e.g. {bad[0]!r})")
            continue
        if len(tokens) != expected:
            rep.warn(f"{split} split lists {len(tokens)} shapes "
                     f"(official: {expected})")
        else:
            rep.ok(f"{split} split: {len(tokens)} shapes")
        missing = 0
        for t in tokens:
            _, synset, sid = t.split("/")
            base = os.path.join(root, synset, sid)
            if not (os.path.exists(base + ".txt")
                    or os.path.exists(base + ".npy")):
                missing += 1
                if missing <= 3:
                    rep.error(f"shape file missing: {base}.txt")
        if missing > 3:
            rep.error(f"... and {missing - 3} more missing {split} shapes")
        if tokens and not missing and not sample_done:
            _, synset, sid = tokens[0].split("/")
            try:
                data = np.loadtxt(os.path.join(root, synset, sid + ".txt"),
                                  max_rows=32)
            except Exception as e:  # noqa: BLE001
                rep.error(f"sample parse failed ({synset}/{sid}.txt): {e} — "
                          "expected whitespace 'x y z nx ny nz part' rows")
                continue
            if data.ndim != 2 or data.shape[1] != 7:
                rep.error(f"sample {synset}/{sid}.txt has shape "
                          f"{data.shape}; expected [*, 7]")
            elif _check_finite(rep, data, f"sample {synset}/{sid}.txt"):
                labels = data[:, 6].astype(np.int64)
                if labels.min() < 0 or labels.max() >= 50:
                    rep.error(f"sample part labels out of global range "
                              f"[0, 50): {labels.min()}..{labels.max()}")
                else:
                    rep.ok(f"parsed sample {synset}/{sid}.txt: [*, 7], "
                           "global part ids in range")
                sample_done = True


def check_partnet(cfg, rep: Report):
    root = os.path.join(cfg.data_root, "sem_seg_h5")
    if not os.path.isdir(root):
        rep.error(f"PartNet root missing: {root} — expected the "
                  "'sem_seg_h5' release (dirs like Chair-3/ of h5 files)")
        return
    rep.ok(f"root: {root}")
    level = int(getattr(cfg, "partnet_level", 3))
    cats = sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d))
                  and d.endswith(f"-{level}"))
    if not cats:
        rep.error(f"no level-{level} category dirs (like 'Chair-{level}') "
                  f"in {root}")
        return
    rep.ok(f"level {level}: {len(cats)} categories "
           f"({', '.join(cats[:4])}{'...' if len(cats) > 4 else ''})")
    import h5py
    for cat in cats:
        for split in ("train", "val", "test"):
            files = sorted(glob.glob(
                os.path.join(root, cat, f"{split}-*.h5")))
            if not files:
                (rep.error if split == "train" else rep.warn)(
                    f"{cat}: no {split}-*.h5 files")
    cat = cats[0]
    files = sorted(glob.glob(os.path.join(root, cat, "train-*.h5")))
    if files:
        try:
            with h5py.File(files[0], "r") as f:
                if "data" not in f or "label_seg" not in f:
                    rep.error(f"{files[0]}: missing 'data'/'label_seg' "
                              f"keys (has: {list(f.keys())})")
                else:
                    d, l = f["data"], f["label_seg"]
                    if d.ndim != 3 or d.shape[2] != 3:
                        rep.error(f"{files[0]}: data shape {d.shape}; "
                                  "expected [S, 10000, 3]")
                    elif d.shape[:2] != l.shape:
                        rep.error(f"{files[0]}: data {d.shape} vs "
                                  f"label_seg {l.shape} row mismatch")
                    else:
                        sample = np.asarray(d[0])
                        if _check_finite(rep, sample, f"{cat} sample"):
                            rep.ok(f"parsed {os.path.basename(files[0])}: "
                                   f"data {d.shape}, labels aligned")
        except OSError as e:
            rep.error(f"h5 open failed: {files[0]}: {e}")


def check_s3dis(cfg, rep: Report):
    cell = cfg.first_subsampling_dl
    cache = os.path.join(cfg.data_root, f"s3dis_processed_{cell:g}")
    raw = os.path.join(cfg.data_root,
                       "Stanford3dDataset_v1.2_Aligned_Version")
    if os.path.isdir(cache):
        files = sorted(glob.glob(os.path.join(cache, "*.npz")))
        rep.ok(f"processed cache: {cache} ({len(files)} rooms)")
        if not files:
            rep.error(f"cache dir exists but holds no room npz: {cache}")
            return
        test_area = f"Area_{cfg.s3dis_test_area}"
        n_test = sum(os.path.basename(f).startswith(test_area)
                     for f in files)
        if n_test == 0:
            rep.error(f"no rooms for test area {test_area} — check "
                      "cfg.s3dis_test_area")
        else:
            rep.ok(f"{test_area}: {n_test} eval rooms, "
                   f"{len(files) - n_test} train rooms")
        z = np.load(files[0])
        need = {"sub_xyz", "sub_rgb", "sub_labels", "full_xyz",
                "full_labels"}
        missing = need - set(z.files)
        if missing:
            rep.error(f"{files[0]}: npz missing keys {sorted(missing)} — "
                      "re-run prepare_rooms()")
        else:
            rep.ok(f"parsed {os.path.basename(files[0])}: "
                   f"{len(z['sub_xyz'])} sub-points / "
                   f"{len(z['full_xyz'])} full points")
        return
    if not os.path.isdir(raw):
        rep.error(
            f"S3DIS not found: neither processed cache {cache} nor raw "
            f"tree {raw} exists. Download "
            "Stanford3dDataset_v1.2_Aligned_Version under cfg.data_root.")
        return
    rep.ok(f"raw tree: {raw} (no cache yet — prep will run at init)")
    areas = sorted(glob.glob(os.path.join(raw, "Area_*")))
    if len(areas) != 6:
        rep.warn(f"{len(areas)} areas found (official: 6)")
    rooms = [r for a in areas for r in sorted(glob.glob(os.path.join(a, "*")))
             if os.path.isdir(r)]
    if not rooms:
        rep.error(f"no room dirs under {raw}/Area_*/")
        return
    rep.ok(f"{len(areas)} areas / {len(rooms)} rooms")
    no_ann = [r for r in rooms
              if not glob.glob(os.path.join(r, "Annotations", "*.txt"))]
    if no_ann:
        rep.error(f"{len(no_ann)} rooms lack Annotations/*.txt "
                  f"(e.g. {no_ann[0]})")
        return
    ann = sorted(glob.glob(os.path.join(rooms[0], "Annotations", "*.txt")))[0]
    try:
        data = np.loadtxt(ann, max_rows=32)
    except Exception as e:  # noqa: BLE001
        rep.error(f"annotation parse failed ({ann}): {e} — expected "
                  "whitespace 'x y z r g b' rows")
        return
    if data.ndim != 2 or data.shape[1] != 6:
        rep.error(f"annotation {ann} has shape {data.shape}; "
                  "expected [*, 6] (xyz + rgb)")
    elif _check_finite(rep, data, os.path.basename(ann)):
        rep.ok(f"parsed {os.path.basename(ann)}: [*, 6], finite")


_CHECKS = {
    "modelnet40": check_modelnet40,
    "shapenetpart": check_shapenetpart,
    "partnet": check_partnet,
    "s3dis": check_s3dis,
}


def check_data(cfg) -> Report:
    """Validate the on-disk tree for cfg.datasets; returns a Report."""
    rep = Report()
    name = cfg.datasets
    if name.startswith("synthetic"):
        rep.ok(f"dataset '{name}' is procedural — nothing on disk to check")
        return rep
    fn = _CHECKS.get(name)
    if fn is None:
        rep.error(f"unknown dataset: {name}")
        return rep
    fn(cfg, rep)
    return rep
