"""Summarise a DfDP training log as an epoch table (a copy of
scripts/watch_dfdp_training.py for the port's log).

Parses the log that ``python -m sdirt_tpu_torch.dfdp_net --stage train``
writes (``dfdp/monitor.py``'s ResultsMonitor lines and the trainer's epoch
lines) and prints per epoch: synthetic-validation acc1, real-box acc1,
train loss.

  python -m sdirt_tpu_torch.watch_dfdp_training LOGFILE [--floor 0.313]
"""

import argparse
import re


def parse(path):
    val, box, loss = {}, {}, {}
    ctx = None
    with open(path, errors="replace") as f:
        for line in f:
            if "Validate Depth Est" in line:
                ctx = "val"
            else:
                m = re.search(r"Test Depth Est on (\w+)", line)
                if m:
                    # only the box scene is tabulated; flat/casual acc lines
                    # must not overwrite it
                    ctx = "box" if m.group(1) == "box" else None
            m = re.search(r"Avg_acc_est\((\d+)\): ([\d.]+)", line)
            if m and ctx in ("val", "box"):
                (val if ctx == "val" else box)[int(m.group(1))] = \
                    float(m.group(2))
            m = re.search(r"Epoch (\d+): train loss ([\d.]+)", line)
            if m:
                loss[int(m.group(1))] = float(m.group(2))
    return val, box, loss


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("log")
    ap.add_argument("--floor", type=float, default=None,
                    help="best-constant-predictor val acc1 to annotate")
    args = ap.parse_args(argv)
    val, box, loss = parse(args.log)
    hdr = "epoch  val_acc1  box_acc1  train_loss"
    if args.floor is not None:
        hdr += f"   (constant floor {args.floor:.3f})"
    print(hdr)
    for e in sorted(val):
        mark = ""
        if args.floor is not None and val[e] > args.floor:
            mark = "  *above floor*"
        print(f"{e:5d}  {val.get(e, float('nan')):.4f}    "
              f"{box.get(e, float('nan')):.4f}    "
              f"{loss.get(e - 1, float('nan')):.4f}{mark}")


if __name__ == "__main__":
    main()
