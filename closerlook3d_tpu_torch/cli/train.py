"""Train entry point (``closerlook3d_tpu/cli/train.py``): one CLI for every
dataset, dispatching on the config's ``datasets``, with dotted key=value
overrides typed as YAML types them. The config is read without PyYAML
(``utils/config.py::read_yaml``).

    python -m closerlook3d_tpu_torch.cli.train --cfg configs/modelnet40/pospool_xyz_avg.yaml
    python -m closerlook3d_tpu_torch.cli.train --cfg ... epochs=10 pospool.reduction=max
    python -m closerlook3d_tpu_torch.cli.train --cfg ... --device cpu
    python -m closerlook3d_tpu_torch.cli.train --cfg ... --check_data

It trains on the card unless ``--device`` names another device, and
ends by printing, on every process, one JSON line: its rank, the world
size, the step it resumed from (null on a fresh run), its last step and
the best validation value. Under torchrun each process is one
data-parallel rank (``parallel/mesh.py``: NCCL where every rank has a
card, gloo where ranks share one or on the CPU with ``--device cpu``),
``batch_size`` clouds a rank and step:

    torchrun --nproc_per_node 2 -m closerlook3d_tpu_torch.cli.train --cfg ...
"""

from __future__ import annotations

import argparse

from closerlook3d_tpu_torch.utils.config import load_config, parse_overrides
from closerlook3d_tpu_torch.utils.logger import print_json_line


def main(argv=None):
    p = argparse.ArgumentParser(description="CloserLook3D training (PyTorch)")
    p.add_argument("--cfg", required=False, default=None,
                   help="YAML experiment config")
    p.add_argument("--log_dir", default="runs/default")
    p.add_argument("--load_path", default=None,
                   help="checkpoint dir to warm-start weights from")
    p.add_argument("--check_data", action="store_true",
                   help="validate the on-disk dataset tree and exit")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    p.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = p.parse_args(argv)
    cfg = load_config(args.cfg, parse_overrides(args.overrides))

    if args.check_data:
        from closerlook3d_tpu_torch.data.check import check_data
        rep = check_data(cfg)
        print(rep.render())
        raise SystemExit(1 if rep.has_errors else 0)

    import torch.distributed as dist

    from closerlook3d_tpu_torch.parallel import mesh
    from closerlook3d_tpu_torch.train.loop import Trainer
    # leave the group at the end only where this run joined it: a caller
    # already in one keeps it (to train, then evaluate, in one launch)
    joined = (not dist.is_initialized()
              and mesh.maybe_initialize_distributed(args.device))
    try:
        lay = mesh.layout(args.device)
        trainer = Trainer(cfg, args.log_dir, load_path=args.load_path,
                          device=lay.device)
        best = trainer.fit()
        print_json_line({"rank": lay.rank, "world_size": lay.world_size,
                         "resumed_step": trainer.resumed_step,
                         "step": trainer.state.step, "best": best})
        return best
    finally:
        if joined:
            mesh.destroy()


if __name__ == "__main__":
    main()
