"""Train a reduced smollm-family model for a few hundred steps with
checkpoint/restart on PyTorch (the port's version of
``examples/train_tiny.py``), demonstrating the training substrate end to
end.

    PYTHONPATH=src python examples/train_tiny_torch.py [--steps 200]
    PYTHONPATH=src python examples/train_tiny_torch.py --device cpu
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_tiny"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args()
    common = ["--arch", "smollm-360m", "--reduced", "--seq", "128",
              "--batch", "8", "--ckpt-every", "25", "--ckpt-dir",
              args.ckpt_dir]
    if args.device:
        common += ["--device", args.device]

    # phase 1: half the steps, then simulate a crash (process would exit)
    half = max(1, args.steps // 2)
    print(f"=== phase 1: steps 1..{half} ===")
    train_main(common + ["--steps", str(half)])

    # phase 2: restart from the latest checkpoint and finish
    print(f"=== phase 2 (restart): steps {half+1}..{args.steps} ===")
    train_main(common + ["--steps", str(args.steps), "--resume"])


if __name__ == "__main__":
    main()
