"""End-to-end driver example: pre-train a ~smolLM-family model for a few
hundred steps through the workflow runtime (checkpointed, restartable).

    PYTHONPATH=src python -m repro_torch.examples.train_smollm [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_smollm --tiny --device cpu

The full run uses a width-reduced SmolLM (not the 360M flagship) trained on
the deterministic synthetic corpus; loss must drop over the run.  The
train driver runs its segments as tasks of its own pilot, in-process (its
steps need no collective); the driver on a pilot world is ROADMAP item
14b.  Checkpoints go to a temporary directory unless ``--ckpt-dir`` names
one.
"""
import tempfile

from repro_torch.examples import _args
from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = _args.parser(__doc__, ranks=False)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_smollm_")
    if args.tiny:
        steps = args.steps or 40
        argv = ["--arch", "smollm-360m", "--reduced", "--steps", str(steps),
                "--segment", "10", "--batch", "8", "--seq", "128"]
    else:
        steps = args.steps or 200
        argv = ["--arch", "smollm-360m", "--reduced", "--steps", str(steps),
                "--segment", "20", "--batch", "16", "--seq", "256"]
    losses = train_main(argv + ["--ckpt-dir", ckpt, "--device", args.device])
    assert losses[-1] < losses[0], "loss did not improve"
    print(f"[example] trained {steps} steps: "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
