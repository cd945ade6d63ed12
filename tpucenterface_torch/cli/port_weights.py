"""Weight-porting CLI: torch `.pth` -> safetensors.

    python -m tpucenterface_torch.cli.port_weights --pth model.pth --out w.safetensors

Mirrors `tpucenterface/cli/port_weights.py`, with the same arguments and
`--device`. The checkpoint is read on the CPU and written with the port's
numpy `weights.io.save_safetensors`; `--device` names the device whose
availability the run requires (the GPU by default), as every CLI of the
port does.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description="Port torch checkpoint to safetensors")
    p.add_argument("--pth", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--width-mult", type=float, default=1.0)
    p.add_argument("--with-landmarks", action="store_true")
    p.add_argument("--auto-map", action="store_true",
                   help="foreign module names: align by shape/order "
                   "(weights.port.propose_name_map); refuses on "
                   "order-ambiguous same-signature units")
    p.add_argument("--allow-ambiguous", action="store_true",
                   help="with --auto-map: accept an order-ambiguous "
                   "alignment (verify first that the foreign net registers "
                   "its modules in data-flow order: same-shape units port "
                   "crosswise undetected otherwise)")
    p.add_argument("--report", action="store_true",
                   help="print the propose_name_map report (mapping, "
                   "unmatched keys, ambiguous units) and exit without "
                   "writing")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = p.parse_args(argv)

    from tpucenterface_torch.config import ModelConfig, resolve_device
    from tpucenterface_torch.weights.io import save_safetensors
    from tpucenterface_torch.weights.port import load_torch_pth, propose_name_map, read_checkpoint

    resolve_device(args.device)
    cfg = ModelConfig(width_mult=args.width_mult, with_landmarks=args.with_landmarks)
    if args.report:
        prop = propose_name_map(read_checkpoint(args.pth), cfg)
        print(json.dumps(
            {
                "complete": prop["complete"],
                "n_mapped": len(prop["mapping"]),
                "unmatched_twin": prop["unmatched_twin"],
                "unmatched_foreign": prop["unmatched_foreign"],
                "ambiguous": prop["ambiguous"],
            },
            indent=2,
        ))
        return
    variables = load_torch_pth(args.pth, cfg, auto_map=args.auto_map, allow_ambiguous=args.allow_ambiguous)
    save_safetensors(variables, args.out)
    print(f"[port] wrote {args.out}")


if __name__ == "__main__":
    main()
