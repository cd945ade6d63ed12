"""How far two runs of the flagship's fine-tuning part, in either package.

The slow test `tests/test_torch_qat.py::test_flagship_fine_tuned_ap_matches_jax`
holds the port's fine-tuned flagship to the JAX package's. This script
measures what its bounds rest on: the spread between two runs of ONE package
whose float32 sums are taken in other orders (the port on one thread against
several; the JAX package plainly jitted against `torch_ft_ref.exact_jax`),
and, for AdaRound, the port's per-layer decisions from the JAX run's
upstream kernels. Same recipe as the test: the JAX Detector calibrates the
flagship on eight 320 frames, each run fine-tunes from those scales (60 QAT
steps, or W4 with 40 AdaRound steps), installs the result and reads AP on
the 24-scene split.

    JAX_PLATFORMS=cpu python tests/torch_ft_spread.py run port --config w4_adaround --threads 1 --out DIR
    JAX_PLATFORMS=cpu python tests/torch_ft_spread.py run jax_exact --config w4_adaround --out DIR
    JAX_PLATFORMS=cpu python tests/torch_ft_spread.py run port_forced --config w4_adaround --out DIR
    python tests/torch_ft_spread.py compare DIR/port_t1 DIR/jax_exact [--forced DIR/port_forced]

`run` writes NAME.json (report, AP) and NAME.npz (params, weight scales)
under DIR, NAME being the kind and, for the port, "_t<threads>";
`port_forced` reads DIR/jax_exact.npz and replaces each finished layer's
kernel by the JAX run's before the next layer's captures. `compare`
prints AP, the end-to-end losses and, per layer, the AdaRound ratios and
the share of equal rounding decisions (grid indices). CPU only; the JAX
runs take one to two hours at this size, the port's five to twenty
minutes.
"""

import argparse
import contextlib
import importlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARTIFACT = os.path.join(ROOT, "artifacts", "flagship.safetensors")


def _flat(tree, pre=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, pre + (k,)))
        else:
            out["/".join(pre + (k,))] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


def run(kind, config, threads, out):
    sys.path[:0] = [HERE, ROOT]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from torch_ft_ref import exact_jax

    import tpucenterface_torch as T
    from tpucenterface.config import DecodeConfig as JDecode
    from tpucenterface.config import DetectorConfig as JDetectorConfig
    from tpucenterface.data.synth import generate_dataset, render_scene
    from tpucenterface.detector import Detector as JDetector
    from tpucenterface.eval.synth_eval import ap_on_records
    from tpucenterface.preprocess import letterbox_normalize_batch
    from tpucenterface.quant.adaround import adaround as j_adaround
    from tpucenterface.quant.engine import QuantEngine as JQuantEngine
    from tpucenterface.quant.qat import qat_finetune as j_qat
    from tpucenterface.weights.io import load_safetensors as jax_load
    from tpucenterface_torch.quant import QuantEngine, adaround, qat_finetune

    name = f"{kind}_t{threads}" if kind == "port" else kind
    os.makedirs(out, exist_ok=True)
    recs = generate_dataset(os.path.join(out, "recs_" + name), 24, seed=7777, hw_range=(384, 512), min_face=18.0)
    rng = np.random.RandomState(0)
    frames = np.stack([render_scene(rng, hw=(320, 320))[0] for _ in range(8)])
    qat = config == "int8_dw_qat"
    kw = dict(int8_dw=True) if qat else dict(int8_dw=True, weight_bits=4)
    ref = JDetector(variables=jax_load(ARTIFACT), config=JDetectorConfig(decode=JDecode(max_dets=100), default_size=320))
    scales = ref.quantize(calib_images=frames, **kw)
    hws = np.tile(np.array([320, 320], np.int32)[None], (8, 1))
    x = letterbox_normalize_batch(jnp.asarray(frames), jnp.asarray(hws), 320, ref.config.preprocess,
                                  raw=ref.config.model.stem_preprocess)[0]
    if kind.startswith("port"):
        torch.set_num_threads(threads)
        det = T.Detector.from_safetensors(
            ARTIFACT, T.DetectorConfig(decode=T.DecodeConfig(max_dets=100, use_pallas=True), default_size=320),
            device="cpu")
        eng = QuantEngine(det.variables, det.config.model, pp_cfg=det.config.preprocess, device="cpu", **kw)
        eng.set_scales(scales)
        xs = [np.asarray(x, np.float32)]
        if kind == "port_forced":
            if qat:
                raise SystemExit("port_forced is AdaRound's")
            pada = importlib.import_module("tpucenterface_torch.quant.adaround")
            want = np.load(os.path.join(out, "jax_exact.npz"))
            tags = {kp: tag for tag, kp in pada._kernel_paths(eng).items()}
            decided, real_set = {}, pada._tree_set

            def forced(tree, path, value):
                if tuple(path) in tags:
                    decided[tags[tuple(path)]] = value.detach().numpy().copy()
                    value = torch.from_numpy(want["p:" + "/".join(path)]).to(value.dtype)
                return real_set(tree, path, value)

            pada._tree_set = forced
            try:
                rep = adaround(eng, xs, steps=40)
            finally:
                pada._tree_set = real_set
            np.savez(os.path.join(out, name + "_decided.npz"), **decided)
            ap = None
        else:
            rep = qat_finetune(eng, xs, steps=60) if qat else adaround(eng, xs, steps=40)
            out_scales = dict(eng.act_scales, **{f"w:{t}": np.asarray(s) for t, s in eng.weight_scales.items()})
            out_scales.update({"cfg:int8_dw": int(eng.int8_dw), "cfg:weight_bits": eng.weight_bits})
            det.quantize(scales=out_scales, quant_params=eng.p)
            ap = ap_on_records(det, recs, size=320)
    else:
        eng = JQuantEngine(ref.variables, ref.config.model, pp_cfg=ref.config.preprocess, **kw)
        eng.set_scales(scales)
        with exact_jax(eng) if kind == "jax_exact" else contextlib.nullcontext():
            rep = j_qat(eng, [x], steps=60) if qat else j_adaround(eng, [x], steps=40)
        out_scales = dict(eng.act_scales, **{f"w:{t}": np.asarray(s) for t, s in eng.weight_scales.items()})
        out_scales.update({"cfg:int8_dw": int(eng.int8_dw), "cfg:weight_bits": eng.weight_bits})
        ref.quantize(scales=out_scales, quant_params=eng.p)
        ap = ap_on_records(ref, recs, size=320)
    ws = {"w:" + t: np.asarray(s) for t, s in eng.weight_scales.items()}
    np.savez(os.path.join(out, name + ".npz"), **{"p:" + k: v for k, v in _flat(eng.p).items()}, **ws)
    with open(os.path.join(out, name + ".json"), "w") as f:
        json.dump({"config": config, "report": {k: float(v) for k, v in rep.items()}, "ap": ap}, f, indent=1)
    print(name, "report", rep, "AP", ap)


def compare(a, b, forced=None):
    sys.path.insert(0, ROOT)
    from tpucenterface_torch.config import ModelConfig
    from tpucenterface_torch.model.backbone import backbone_plan
    from tpucenterface_torch.quant.engine import conv_node_paths

    ja, jb = json.load(open(a + ".json")), json.load(open(b + ".json"))
    na, nb = np.load(a + ".npz"), np.load(b + ".npz")
    print("AP", ja["ap"], jb["ap"])
    for k in ja["report"]:
        if k.startswith("_") or k in ("loss_first", "loss_bc", "loss_last", "steps"):
            print(k, ja["report"][k], jb["report"].get(k))
    paths = conv_node_paths(backbone_plan(ModelConfig()))
    tags = [t for t in ja["report"] if t in paths and "w:" + t in nb.files]
    if not tags:
        return

    eq = tot = 0
    for tag in tags:
        kp = "p:" + "/".join(paths[tag]) + "/kernel"
        s = nb["w:" + tag]
        same = np.round(na[kp] / s) == np.round(nb[kp] / s)
        eq, tot = eq + int(same.sum()), tot + same.size
        print(f"{tag:14s} ratio {ja['report'][tag]:.4f} {jb['report'][tag]:.4f}  equal decisions {same.mean():.5f} "
              f"of {same.size}")
    print("equal decisions overall", eq / tot)
    if forced:
        dec = np.load(forced + "_decided.npz")
        eq = tot = 0
        low = []
        for tag in tags:
            kp = "p:" + "/".join(paths[tag]) + "/kernel"
            s = nb["w:" + tag]
            same = np.round(dec[tag] / s) == np.round(nb[kp] / s)
            eq, tot = eq + int(same.sum()), tot + same.size
            low.append((float(same.mean()), tag))
        print("forced: equal decisions overall", eq / tot, "least layers", sorted(low)[:5])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("kind", choices=["port", "port_forced", "jax_exact", "jax_jit"])
    r.add_argument("--config", choices=["int8_dw_qat", "w4_adaround"], required=True)
    r.add_argument("--threads", type=int, default=1, help="torch threads of a port run")
    r.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--forced")
    args = ap.parse_args()
    if args.cmd == "run":
        run(args.kind, args.config, args.threads, args.out)
    else:
        compare(args.a, args.b, args.forced)


if __name__ == "__main__":
    main()
