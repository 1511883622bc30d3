"""Inference/eval CLI (reference test.py equivalent; the JAX package's
``training/evaluate.py``).

Usage (on the GPU; add ``--device cpu`` on the CPU):
  python -m awr_tpu_torch.training.evaluate --synthetic
  python -m awr_tpu_torch.training.evaluate --data-dir ./data/nyu \
      --load-model output/nyu/checkpoint_nyu_resnet18/ckpt/2.pth
  python -m awr_tpu_torch.training.evaluate --dataset msra \
      --data-dir ./data/msra --allow-centroid-centers

The JAX package's flags and defaults (``--dataset {nyu,icvl,msra,
hands17}``, ``--data-dir``, ``--data-mode host`` by default: the
reference's host chain), except: no ``--pallas``/``--no-pallas`` (a CUDA
tensor always takes the hand-written kernels), and ``--device`` (default
``cuda``).  Under ``python -m torch.distributed.run --nproc_per_node N``
it evaluates data parallel, one process a GPU (``training/train.py``).
"""

from __future__ import annotations

import argparse

from awr_tpu_torch.config import (DATASET_CUBE, EPOCH, JOINT, STEP, Config,
                                  hourglass_config, resnet_config)


def build_config(args) -> Config:
    if args.net.startswith("resnet"):
        cfg = resnet_config(int(args.net.split("_")[1]))
    else:
        cfg = hourglass_config(int(args.net.split("_")[1]))
    ds = getattr(args, "dataset", "nyu")
    if ds != "nyu":
        cfg = cfg.replace(dataset=ds, jt_num=JOINT[ds], step=STEP[ds],
                          max_epoch=EPOCH[ds], cube=DATASET_CUBE[ds])
    over = dict(
        batch_size=args.batch_size,
        img_size=args.img_size,
        load_model=args.load_model,
        output_dir=args.output_dir,
        vis_freq=args.vis_freq,
        compute_dtype=args.compute_dtype,
    )
    if args.downsample:
        over["downsample"] = args.downsample
    if getattr(args, "ckpt_max_to_keep", 0):
        over["ckpt_max_to_keep"] = args.ckpt_max_to_keep
    return cfg.replace(**over)


def add_common_args(ap: argparse.ArgumentParser):
    ap.add_argument("--net", default="resnet_18",
                    help="resnet_{18,50,101,152} | hourglass_<nstack>")
    ap.add_argument("--dataset", default="nyu",
                    choices=["nyu", "icvl", "msra", "hands17"])
    ap.add_argument("--data-dir", default="./data/nyu")
    ap.add_argument("--output-dir", default="./output")
    ap.add_argument("--load-model", default="",
                    help="checkpoint directory, or a .pth file, to load")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--img-size", type=int, default=128)
    ap.add_argument("--downsample", type=int, default=0,
                    help="override output stride (default: per-net)")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic dataset (no NYU files needed)")
    ap.add_argument("--synthetic-size", type=int, default=32)
    ap.add_argument("--synthetic-test-size", type=int, default=0,
                    help="test-split size (0 = same as --synthetic-size)")
    ap.add_argument("--ckpt-max-to-keep", type=int, default=0,
                    help="keep only the newest N epoch checkpoints "
                         "(0 = keep all, reference behavior)")
    ap.add_argument("--vis-freq", type=int, default=0,
                    help="overlay PNG every N batches (0=off)")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--data-mode", default="host",
                    choices=["host", "raw"],
                    help="'host': the reference's crop and augmentation "
                         "on the host; 'raw': both on the device")
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler Chrome trace here: "
                         "the kernels, the operators and the program's "
                         "own awr_tpu_torch.* spans")
    ap.add_argument("--allow-centroid-centers", action="store_true",
                    help="msra/hands17: accept joint-centroid crop "
                         "centers when refined center files are absent "
                         "(a DIFFERENT crop distribution; PARITY.md)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")


def make_datasets(args, cfg: Config, train: bool = False):
    mode = getattr(args, "data_mode", "host")
    if args.synthetic:
        from awr_tpu_torch.data.synthetic import SyntheticHandDataset

        test_size = (getattr(args, "synthetic_test_size", 0)
                     or args.synthetic_size)
        test = SyntheticHandDataset(test_size, cfg.jt_num, cfg.img_size,
                                    phase="test", seed=1, mode=mode)
        tr = (SyntheticHandDataset(args.synthetic_size, cfg.jt_num,
                                   cfg.img_size, phase="train", seed=0,
                                   mode=mode)
              if train else None)
        return tr, test

    from awr_tpu_torch.data import (Hands17Dataset, ICVLDataset,
                                    MSRADataset, NYUDataset)

    cls = {"nyu": NYUDataset, "icvl": ICVLDataset, "msra": MSRADataset,
           "hands17": Hands17Dataset}[getattr(args, "dataset", "nyu")]
    kw = dict(img_size=cfg.img_size, cube=cfg.cube, mode=mode)
    if cls in (MSRADataset, Hands17Dataset):
        kw["allow_centroid_centers"] = getattr(
            args, "allow_centroid_centers", False)
    test = cls(args.data_dir, "test", **kw)
    tr = (cls(args.data_dir, "train", aug_para=cfg.augment_para, **kw)
          if train else None)
    return tr, test


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--epoch", type=int, default=-1,
                    help="epoch tag for outputs (-1 dumps predictions, "
                         "matching reference test.py:102-108)")
    args = ap.parse_args(argv)
    cfg = build_config(args)

    from awr_tpu_torch.parallel.multihost import initialize_distributed
    from awr_tpu_torch.training.trainer import Trainer

    initialize_distributed(device=args.device)
    _, test = make_datasets(args, cfg)
    trainer = Trainer(cfg, test_data=test, device=args.device)
    if args.profile_dir:
        from awr_tpu_torch.utils.profiling import trace

        with trace(args.profile_dir):
            mpe, auc = trainer.test(args.epoch)
    else:
        mpe, auc = trainer.test(args.epoch)
    print(f"results: [MPE {mpe:.3f}][AUC {auc:.3f}]")
    trainer.close()
    return mpe


if __name__ == "__main__":
    from awr_tpu_torch.parallel.multihost import shutdown_distributed

    main()
    shutdown_distributed()
