"""The port's command-line apps (`tpucenterface_torch/cli/`) on the CPU, at
small sizes with `--device cpu`.

- Argument errors: every `p.error` case of each ported CLI, and argparse's
  own, exits with code 2 and the JAX CLI's message (the JAX CLIs stop at the
  same check, before they build anything).
- `port_weights` (plain, `--auto-map`, `--report`) writes or prints what the
  JAX CLI does, at width 0.5.
- `serve`: its `--out` lines equal a direct `detect_batch` of the same
  Detector up to the CLI's 2- and 4-decimal rounding (every launch on the
  one rung of `--ladder 4`, the direct calls in batches of 4); the scales
  round trip, the QAT round trip, `--save-packed` then `--packed`, and
  `--int8-input` bit-identical to the uint8 staging.
- `demo` on synthetic frames, headless and with `--out`.
- `eval_wider` on the synthetic `.mat` ground truth against the port's
  `evaluate_wider` called directly (batched, per-image TTA, int8).
- `parity_report`: the twin contract passes, the foreign auto-map passes
  (and refuses without `--allow-ambiguous`), and corrupted weights exit 1.
- `flagship_tta` and `flagship_pins` on two scenes: the table's keys, and its
  values against the functions they drive.
The serve, demo and eval cases run the default (full-width) random model,
the CLIs' own, at 64x64.
"""

import json
import os

import numpy as np
import pytest
import torch

import tpucenterface_torch as T
from tpucenterface.cli import demo as jdemo
from tpucenterface.cli import eval_wider as jeval_wider
from tpucenterface.cli import flagship_pins as jflagship_pins
from tpucenterface.cli import flagship_tta as jflagship_tta
from tpucenterface.cli import parity_report as jparity_report
from tpucenterface.cli import port_weights as jport_weights
from tpucenterface.cli import serve as jserve
from tpucenterface.config import ModelConfig as JModel
from tpucenterface.weights.torch_twin import TorchCenterFace as JTwin
from tpucenterface_torch.cli import demo, eval_wider, flagship_pins, flagship_tta, parity_report, port_weights, serve
from tpucenterface_torch.preprocess import pad_to_bucket
from tpucenterface_torch.weights.io import load_safetensors, read_safetensors_flat
from test_parity import _foreign_renamed_state
from test_wider_eval import _fake_image_dataset, _write_synthetic_mat_gt
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "flagship.safetensors")
CPU = ["--device", "cpu"]
SERVE = ["--source", "synthetic", "--n-synthetic", "6", "--device-batch", "4", "--size", "64",
         "--thresh", "-1.0"] + CPU


# --------------------------------------------------------------------------- #
# argument errors
# --------------------------------------------------------------------------- #

ERRORS = {
    "serve_packed_scales": (serve, jserve, ["--packed", "p.npz", "--scales", "s.json"]),
    "serve_packed_qat_params": (serve, jserve, ["--packed", "p.npz", "--qat-params", "q.safetensors"]),
    "serve_packed_qat_steps": (serve, jserve, ["--packed", "p.npz", "--qat-steps", "5"]),
    "serve_packed_adaround": (serve, jserve, ["--packed", "p.npz", "--adaround-steps", "5"]),
    "serve_save_packed_no_int8": (serve, jserve, ["--save-packed", "p.npz"]),
    "serve_int8_input_no_int8": (serve, jserve, ["--int8-input"]),
    "serve_qat_steps_with_scales": (serve, jserve, ["--int8", "--scales", "s.json", "--qat-steps", "5"]),
    "serve_adaround_with_scales": (serve, jserve, ["--int8", "--scales", "s.json", "--adaround-steps", "5"]),
    "serve_qat_params_no_scales": (serve, jserve, ["--int8", "--qat-params", "q.safetensors"]),
    "serve_bad_int": (serve, jserve, ["--n-synthetic", "many"]),
    "serve_no_value": (serve, jserve, ["--source"]),
    "eval_int8_dw_no_int8": (eval_wider, jeval_wider, ["--gt-dir", "g", "--images-root", "r", "--int8-dw"]),
    "eval_missing_required": (eval_wider, jeval_wider, ["--gt-dir", "g"]),
    "port_missing_out": (port_weights, jport_weights, ["--pth", "w.pth"]),
    "parity_missing_pth": (parity_report, jparity_report, ["--size", "128"]),
    "demo_bad_size": (demo, jdemo, ["--size", "big"]),
    "tta_bad_scales": (flagship_tta, jflagship_tta, ["--scales", "a"]),
    "pins_bad_calib": (flagship_pins, jflagship_pins, ["--calib", "1.5"]),
}


def _exit(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    err = capsys.readouterr().err
    return e.value.code, err.strip().splitlines()[-1]


@pytest.mark.parametrize("case", list(ERRORS))
def test_argument_errors_equal_jax(case, capsys):
    mod, jmod, argv = ERRORS[case]
    code, msg = _exit(mod.main, argv + CPU, capsys)
    jcode, jmsg = _exit(jmod.main, argv, capsys)
    assert code == jcode == 2
    assert msg == jmsg and "error:" in msg


# --------------------------------------------------------------------------- #
# port_weights
# --------------------------------------------------------------------------- #


def _twin_state(seed, **cfg):
    torch.manual_seed(seed)
    return JTwin(JModel(**cfg)).eval().state_dict()


def test_port_weights_cli_equals_jax(tmp_path, capsys):
    pth = str(tmp_path / "twin.pth")
    torch.save({"state_dict": _twin_state(3, width_mult=0.5)}, pth)
    _, foreign = _foreign_renamed_state(JModel(width_mult=0.5))
    fpth = str(tmp_path / "foreign.pth")
    torch.save(foreign, fpth)
    for src, extra in ((pth, []), (fpth, ["--auto-map", "--allow-ambiguous"])):
        out, jout = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
        port_weights.main(["--pth", src, "--out", out, "--width-mult", "0.5"] + extra + CPU)
        jport_weights.main(["--pth", src, "--out", jout, "--width-mult", "0.5"] + extra)
        got, want = read_safetensors_flat(out), read_safetensors_flat(jout)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    capsys.readouterr()
    for src in (pth, fpth):
        out = str(tmp_path / "report.safetensors")
        port_weights.main(["--pth", src, "--out", out, "--width-mult", "0.5", "--report"] + CPU)
        got = capsys.readouterr().out
        jport_weights.main(["--pth", src, "--out", out, "--width-mult", "0.5", "--report"])
        assert got == capsys.readouterr().out
        rep = json.loads(got)
        assert rep["n_mapped"] > 0 and not rep["unmatched_twin"] and rep["ambiguous"] and not rep["complete"]
        assert not os.path.exists(out)  # report mode writes nothing


# --------------------------------------------------------------------------- #
# serve
# --------------------------------------------------------------------------- #


def _lines(path):
    return [json.loads(line) for line in open(path)]


def _same_lines(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra == rb


def test_serve_out_lines_equal_detect_batch(tmp_path, capsys):
    out = str(tmp_path / "dets.jsonl")
    serve.main(SERVE + ["--ladder", "4", "--out", out])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["images"] == 6 and summary["faces"] == 600
    assert set(summary["engines"]) == {"(128, 128)"}
    assert summary["engines"]["(128, 128)"]["images"] == 6
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 255, (64, 64, 3), np.uint8) for _ in range(6)]
    # the serving decode's K (`--max-dets`, 100)
    det = T.Detector(config=T.DetectorConfig(decode=T.DecodeConfig(max_dets=100), default_size=64), device="cpu")
    # each launch as the engine makes it: 4 rows padded to the (128, 128)
    # bucket, pad rows black with hw 1
    direct = []
    for s in range(0, 6, 4):
        batch = np.zeros((4, 128, 128, 3), np.uint8)
        hws = np.ones((4, 2), np.int32)
        for j, im in enumerate(imgs[s:s + 4]):
            batch[j] = pad_to_bucket(im)
            hws[j] = (64, 64)
        direct += det.detect_batch(batch, hws=hws, score_thresh=-1.0)[: len(imgs[s:s + 4])]
    lines = _lines(out)
    assert [r["image"] for r in lines] == [f"synthetic_{i}" for i in range(6)]
    for r, d in zip(lines, direct):
        assert r["boxes"] == np.round(d.boxes, 2).tolist()
        assert r["scores"] == np.round(d.scores, 4).tolist()


def test_serve_scales_round_trip(tmp_path):
    out1, out2, scales = (str(tmp_path / n) for n in ("a.jsonl", "b.jsonl", "scales.json"))
    common = SERVE + ["--int8", "--int8-dw"]
    serve.main(common + ["--save-scales", scales, "--out", out1])
    serve.main(common + ["--scales", scales, "--out", out2])
    _same_lines(_lines(out1), _lines(out2))


def test_serve_qat_round_trip(tmp_path, capsys):
    out1, out2, scales, qparams = (str(tmp_path / n) for n in ("q.jsonl", "r.jsonl", "s.json", "q.safetensors"))
    common = SERVE + ["--int8", "--int8-dw"]
    serve.main(common + ["--qat-steps", "2", "--save-scales", scales, "--save-qat-params", qparams, "--out", out1])
    text = capsys.readouterr().out
    assert "QAT fine-tune" in text and "loss_first" in text
    serve.main(common + ["--scales", scales, "--qat-params", qparams, "--out", out2])
    _same_lines(_lines(out1), _lines(out2))


def test_serve_packed_round_trip(tmp_path, capsys):
    out1, out2, packed = (str(tmp_path / n) for n in ("q.jsonl", "p.jsonl", "m.npz"))
    serve.main(SERVE + ["--int8", "--int8-dw", "--save-packed", packed, "--out", out1])
    serve.main(SERVE + ["--packed", packed, "--out", out2])
    assert "weight_bits=8 int8_dw=True" in capsys.readouterr().out
    a, b = _lines(out1), _lines(out2)
    assert len(a) == len(b) == 6
    for ra, rb in zip(a, b):  # float dust: the artifact re-derives unfrozen scales
        np.testing.assert_allclose(ra["scores"], rb["scores"], atol=1e-6)
        np.testing.assert_allclose(ra["boxes"], rb["boxes"], atol=1e-3)


def test_serve_int8_input_bit_identical(tmp_path):
    out1, out2 = str(tmp_path / "u8.jsonl"), str(tmp_path / "i8.jsonl")
    common = SERVE + ["--int8", "--int8-dw"]
    serve.main(common + ["--out", out1])
    serve.main(common + ["--int8-input", "--out", out2])
    _same_lines(_lines(out1), _lines(out2))


def test_serve_pth_weights_and_calibration_frames(tmp_path):
    """`--weights` takes a `.pth` (from_torch_pth); calibration frames of
    the model size are used as they are, others are resized with cv2."""
    import cv2

    pth = str(tmp_path / "w.pth")
    torch.save(_twin_state(5), pth)
    det = serve.load_detector(pth, "cpu", "serve")
    want = T.Detector.from_torch_pth(pth, device="cpu")
    for a, b in zip(det.variables["params"]["backbone"]["stem"]["conv"].values(),
                    want.variables["params"]["backbone"]["stem"]["conv"].values()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    frames = [np.full((64, 64, 3), 9, np.uint8), np.arange(48 * 80 * 3, dtype=np.uint8).reshape(48, 80, 3)]
    got = serve._calibration_frames(frames, 64)
    assert got[0].tobytes() == frames[0].tobytes()
    assert got[1].tobytes() == cv2.resize(frames[1], (64, 64)).tobytes()
    assert cv2.resize(frames[0], (64, 64)).tobytes() == frames[0].tobytes()


# --------------------------------------------------------------------------- #
# demo
# --------------------------------------------------------------------------- #


def test_demo_on_synthetic_frames(tmp_path, monkeypatch, capsys):
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 255, (96, 128, 3), np.uint8) for _ in range(5)]
    monkeypatch.setattr(demo, "_frames", lambda source: iter(frames))
    demo.main(["--source", "synthetic", "--size", "64", "--max-frames", "4"] + CPU)
    out = capsys.readouterr().out
    assert "4 frames" in out and " fps" in out and "0.0 fps" not in out
    video = str(tmp_path / "out.mp4")
    demo.main(["--source", "synthetic", "--size", "64", "--out", video] + CPU)
    assert "5 frames" in capsys.readouterr().out
    assert os.path.getsize(video) > 0


# --------------------------------------------------------------------------- #
# eval_wider
# --------------------------------------------------------------------------- #


@pytest.fixture
def wider(tmp_path):
    gt_dir, img_root = str(tmp_path / "gt"), str(tmp_path / "imgs")
    os.makedirs(gt_dir)
    _write_synthetic_mat_gt(gt_dir)
    _fake_image_dataset(img_root)
    return gt_dir, img_root


def _ap_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_eval_wider_cli_equals_evaluate_wider(wider, tmp_path, capsys):
    from tpucenterface_torch.data.wider import write_wider_detections
    from tpucenterface_torch.eval.batch_runner import batched_detect
    from tpucenterface_torch.eval.tta import detect_tta
    from tpucenterface_torch.eval.wider_eval import evaluate_wider

    gt_dir, img_root = wider
    dets_dir, want_dir = str(tmp_path / "dets"), str(tmp_path / "want")
    base = ["--gt-dir", gt_dir, "--images-root", img_root, "--size", "64", "--thresh", "0.001"] + CPU
    det = T.Detector(config=T.DetectorConfig(default_size=64), device="cpu")

    eval_wider.main(base + ["--out-dets", dets_dir, "--batch-size", "4"])
    want = evaluate_wider(
        None, gt_dir, img_root,
        on_detection=lambda rel, b, s: write_wider_detections(want_dir, rel, b, s),
        batch_det_fn=lambda imgs: batched_detect(det, imgs, score_thresh=0.001, batch_size=4),
    )
    assert _ap_line(capsys) == {f"AP_{k}": round(v, 4) for k, v in want.items()}
    for rel in ("ev_a/img1.txt", "ev_a/img2.txt", "ev_b/img3.txt"):
        assert open(os.path.join(dets_dir, rel)).read() == open(os.path.join(want_dir, rel)).read()

    eval_wider.main(base + ["--per-image", "--tta", "--scales", "1.0"])
    want = evaluate_wider(lambda img: detect_tta(det, img, scales=(1.0,), flip=True, score_thresh=0.001),
                          gt_dir, img_root)
    assert _ap_line(capsys) == {f"AP_{k}": round(v, 4) for k, v in want.items()}


def test_eval_wider_cli_int8(wider, capsys):
    gt_dir, img_root = wider
    eval_wider.main(["--gt-dir", gt_dir, "--images-root", img_root, "--int8", "--int8-dw", "--batch-size", "4",
                     "--size", "64"] + CPU)
    lines = capsys.readouterr().out.strip().splitlines()
    assert "[eval] int8 forward calibrated on 3 eval images" in lines
    out = json.loads(lines[-1])
    assert set(out) == {"AP_easy", "AP_medium", "AP_hard"} and all(0.0 <= v <= 1.0 for v in out.values())


# --------------------------------------------------------------------------- #
# parity_report
# --------------------------------------------------------------------------- #


def _reference_pth(tmp_path, seed):
    """A reference checkpoint of the default model with real running
    statistics and box sizes (tests/test_parity_report.py::_twin_pth)."""
    torch.manual_seed(seed)
    twin = JTwin(JModel(compute_dtype="float32")).eval()
    with torch.no_grad():
        for m in twin.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)
        twin.heads.wh.out.bias.fill_(2.0)
    path = str(tmp_path / f"ref{seed}.pth")
    torch.save(twin.state_dict(), path)
    return path


@pytest.fixture(scope="module")
def scenes():
    """Two rendered scenes (the default scenes need cv2 too, so the tests
    pass them in)."""
    from tpucenterface_torch.data.synth import render_scene

    return [render_scene(np.random.RandomState(100 + i), (180, 240))[0] for i in range(2)]


def test_parity_report_twin_contract_passes(tmp_path, scenes, monkeypatch):
    monkeypatch.setattr(parity_report, "_sample_images", lambda paths: scenes)
    out = str(tmp_path / "report.json")
    assert parity_report.main(["--pth", _reference_pth(tmp_path, 0), "--size", "128", "--out", out] + CPU) == 0
    report = json.load(open(out))
    assert report["pass"] and report["port"]["mode"] == "twin-contract"
    layers = report["layers"]
    assert layers["pass"] and layers["n_layers_compared"] >= 100 and layers["worst_abs_diff"] <= layers["atol"]
    names = [r["layer"] for r in layers["layers"]]
    assert names[0].startswith("backbone.stem")
    assert any(n.startswith("neck.") for n in names) and {"heads.hm", "heads.wh", "heads.off"} <= set(names)
    assert report["boxes"]["pass"] and report["boxes"]["worst_match_frac"] >= 0.9
    assert len(report["boxes"]["images"]) == 2 and "ap" not in report


def test_parity_report_foreign_auto_map(tmp_path, scenes, monkeypatch):
    monkeypatch.setattr(parity_report, "_sample_images", lambda paths: scenes)
    sd = torch.load(_reference_pth(tmp_path, 3), weights_only=False)
    foreign = {f"net.{i // 4}.{i % 4}.{k.rsplit('.', 1)[-1]}": v for i, (k, v) in enumerate(sd.items())}
    fpth = str(tmp_path / "foreign.pth")
    torch.save(foreign, fpth)
    with pytest.raises(SystemExit, match="ambiguous"):
        parity_report.main(["--pth", fpth, "--auto-map", "--size", "128"] + CPU)
    out = str(tmp_path / "report.json")
    assert parity_report.main(["--pth", fpth, "--auto-map", "--allow-ambiguous", "--size", "128", "--out", out]
                              + CPU) == 0
    report = json.load(open(out))
    assert report["port"]["mode"] == "auto-map" and report["port"]["ambiguous"] and report["pass"]


def test_parity_report_corrupted_weights_exit_1(tmp_path, scenes, monkeypatch):
    """The twin gets a checkpoint with one mid-network conv perturbed, the
    port the clean one: the layer gate fails and the command exits 1 (as
    the stage itself reports, tests/test_parity_report.py)."""
    from tpucenterface_torch.weights.port import variables_from_torch_state

    monkeypatch.setattr(parity_report, "_sample_images", lambda paths: scenes)
    good = _reference_pth(tmp_path, 9)
    sd = torch.load(good, weights_only=False)
    k = "backbone.block_3.project.conv.weight"
    bad = dict(sd, **{k: sd[k] + 0.05})
    cfg = T.ModelConfig(compute_dtype="float32")
    clean = variables_from_torch_state(sd, cfg)
    report, _ = parity_report.layer_stage(cfg, bad, clean, 128, 2e-3)
    assert not report["pass"] and report["worst_abs_diff"] > 2e-3
    # a NaN difference fails the gate (the JAX stage's max() drops it)
    k = "backbone.block_5.expand.bn.running_var"
    nan = dict(sd, **{k: -sd[k]})
    report, _ = parity_report.layer_stage(cfg, nan, variables_from_torch_state(nan, cfg), 128, 2e-3)
    assert not report["pass"] and np.isnan(report["worst_abs_diff"])

    real = parity_report.port_stage
    monkeypatch.setattr(parity_report, "port_stage", lambda args, c: (real(args, c)[0], bad, clean))
    out = str(tmp_path / "report.json")
    assert parity_report.main(["--pth", good, "--size", "128", "--out", out] + CPU) == 1
    assert not json.load(open(out))["pass"]


# --------------------------------------------------------------------------- #
# flagship_tta and flagship_pins
# --------------------------------------------------------------------------- #

SCENE_ARGS = ["--val-images", "2", "--hw-min", "96", "--hw-max", "128", "--min-face", "12", "--input-size", "64"]


def _records(data_dir, split, n, seed):
    from tpucenterface_torch.data.synth import generate_dataset

    return generate_dataset(os.path.join(data_dir, split), n, seed=seed, hw_range=(96, 128), min_face=12.0)


def test_flagship_tta_table(tmp_path):
    from tpucenterface_torch.eval.synth_eval import ap_on_records, ap_on_records_tta

    out = str(tmp_path / "tta.json")
    assert flagship_tta.main(["--workdir", str(tmp_path), "--weights", ARTIFACT, "--out", out] + SCENE_ARGS
                             + CPU) == 0
    report = json.load(open(out))
    assert set(report["ap"]) == {"single", "flip", "flip_multiscale"}
    assert report["scales"] == [0.7, 1.0] and report["input_size"] == 64
    recs = _records(os.path.join(str(tmp_path), "data"), "val", 2, 7777)
    det = T.Detector(variables=load_safetensors(ARTIFACT), config=T.DetectorConfig(
        decode=T.DecodeConfig(max_dets=100), default_size=64), device="cpu")
    assert report["ap"]["single"] == ap_on_records(det, recs, size=64)
    assert report["ap"]["flip"] == ap_on_records_tta(det, recs, scales=[0.7], flip=True)
    assert report["ap"]["flip_multiscale"] == ap_on_records_tta(det, recs, scales=[0.7, 1.0], flip=True)


def test_flagship_pins_table(tmp_path):
    import cv2

    from tpucenterface_torch.eval.synth_eval import ap_on_records

    out = str(tmp_path / "pins.json")
    assert flagship_pins.main(["--workdir", str(tmp_path), "--weights", ARTIFACT, "--out", out, "--calib", "2",
                               "--qat-steps", "1", "--adaround-steps", "1"] + SCENE_ARGS + CPU) == 0
    report = json.load(open(out))
    rows = ["float", "int8", "int8_dw", "int8_dw_qat", "w4_nearest", "w4_adaround"]
    assert list(report["ap"]) == rows and list(report["delta_vs_float"]) == rows[1:]
    assert {"int8_dw_qat_qat_metrics", "w4_adaround_adaround_e2e"} <= set(report)
    for name in rows[1:]:
        for k, v in report["delta_vs_float"][name].items():
            assert v == round(report["ap"][name][k] - report["ap"]["float"][k], 4)
    data = os.path.join(str(tmp_path), "data")
    recs = _records(data, "val", 2, 7777)
    calib = np.stack([cv2.resize(cv2.imread(r.path), (64, 64)) for r in _records(data, "train", 2, 0)])
    det = T.Detector(variables=load_safetensors(ARTIFACT), config=T.DetectorConfig(
        decode=T.DecodeConfig(max_dets=100), default_size=64), device="cpu")
    assert report["ap"]["float"] == ap_on_records(det, recs, size=64)
    det.quantize(calib_images=calib, int8_dw=True)
    assert report["ap"]["int8_dw"] == ap_on_records(det, recs, size=64)
