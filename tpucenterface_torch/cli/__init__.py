"""Command-line entry points of the port, run as modules from the repo root:

    python -m tpucenterface_torch.cli.serve --source DIR --weights w.pth
    python -m tpucenterface_torch.cli.demo --source video.mp4 --weights w.pth
    python -m tpucenterface_torch.cli.eval_wider --gt-dir eval_tools/ground_truth --images-root DIR
    python -m tpucenterface_torch.cli.port_weights --pth model.pth --out w.safetensors
    python -m tpucenterface_torch.cli.parity_report --pth model.pth
    python -m tpucenterface_torch.cli.train --wider-root /data/WIDER --workdir runs/x
    python -m tpucenterface_torch.cli.train_flagship --workdir runs/flagship
    python -m tpucenterface_torch.cli.flagship_tta --workdir runs/flagship
    python -m tpucenterface_torch.cli.flagship_pins --workdir runs/flagship
    python -m tpucenterface_torch.cli.bench_suite --configs 1,2,3,4,5

Each takes the JAX package's arguments (`tpucenterface/cli/`) and `--device`:
the GPU unless it names another (`--device cpu`); nothing falls back to the
CPU.
"""
