"""tools/int8_map_study_torch.py, the port's int8 accuracy study, held
stage by stage to the same composition of bcnn_tpu's functions
(tools/int8_map_study.py's: `make_detect_fn`, `ops.quant.calibrate` with
each method, `quantize_weights`, QAT through `make_train_scan` and
`Session.freeze_qat`) on the same checkpoint and record sets.

Set-up: the record sets of both packages' example drivers (8 images at
64 px, and a held-out 8; `write_dataset` then `records_from_loader`),
byte for byte equal, and a short checkpoint of the port's soak
(`examples_torch/train_soak.py`, 4 steps from He-scaled seeded weights:
the nets' own fillers put infinite boxes out of a 4-step detector). The
held-out labels are then the checkpoint's own top fp32 detections, so
that the fp32 mAP is not degenerate (a 4-step detector finds nothing of
the real boxes).

The study runs at --compute fp32 (the convs' inputs and the
fine-tune's activations fp32) on both sides: at bf16, an fp32 sum one ulp
apart in the two packages rounds a later layer's input to the
neighbouring bf16 value, and a tensor's 99.9th percentile moves with it
by up to 5% (measured); the default bf16 path is held by its fp32
stage's mAP.

Bounds: the activation scales of absmax and percentile within rtol
1e-4 of bcnn_tpu's (SCALE_RTOL), the KL thresholds (each range's clip
bin of 2048) equal; the int8 weights equal, code for code; the int8 heads of the
held-out batch within tests/test_torch_quant.HEAD_TOL of bcnn_tpu's
largest head value (the port's int8 bound against bcnn_tpu); the frozen
QAT scales within QAT_RTOL; each stage's mAP within 0.02 of bcnn_tpu's (a
near-threshold detection may flip; equal where none does). The fine-tune runs with no flip on either side (`--qat-fliph 0`,
`{"random_fliph": 0}`): JAX's threefry draws cannot be matched.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_quant import HEAD_TOL

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BATCH, IMAGES, SRC = 64, 8, 8, 96
STUDY = ["--batch", str(BATCH), "--size", str(SIZE), "--images",
         str(IMAGES), "--calib-batches", "1", "--calib-chunk", "4",
         "--qat-steps", "5", "--qat-batch", "4", "--qat-fliph", "0",
         "--compute", "fp32", "--device", "cpu"]
MAP_TOL = 0.02
# the fp32 forward's bound against bcnn_tpu in every parity test of the
# port (FWD_RTOL): a scale is an abs-max or a percentile of activations
# that agree within it (the percentile measured 1.3e-5 apart here, where
# two order statistics of a tail swap under another order of sums)
SCALE_RTOL = 1e-4
# the QAT ranges: the abs-max of the fine-tune's activations, where a
# fake-quant input on a rounding boundary of x / s takes another code in
# each package and, through BN over 16 values a channel at the 2x2
# stages, moves the later layers' ranges (tests/test_torch_qat.py holds
# YOLOv3-tiny's QAT step on bcnn_tpu's codes for that reason); measured
# up to 3.0% apart after the first step here
QAT_RTOL = 2.0**-4

def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _own_labels(erec, ckpt):
    """Rewrite the held-out records' labels as the checkpoint's top fp32
    detections (at most 3 an image, score > 0): [x, y, w, h, class]."""
    from bcnn_tpu_torch import Mode
    from bcnn_tpu_torch.checkpoint import load_checkpoint
    from bcnn_tpu_torch.compile import make_detect_fn
    from bcnn_tpu_torch.data import RawRecordLoader
    from bcnn_tpu_torch.metrics_det import dets_to_rows

    study = _load(os.path.join(ROOT, "tools", "int8_map_study_torch.py"),
                  "int8_map_study_torch")
    net = study.yolo_net(BATCH, SIZE, Mode.PREDICT, "fp32")
    params, state, _, _ = load_checkpoint(net, ckpt, "cpu")
    loader = RawRecordLoader(net, erec)
    x, lab = loader.next_batch()
    loader.close()
    with torch.inference_mode():
        bx, sc, _ = make_detect_fn(net, 0.005, 100)(
            params, state, {"input": torch.from_numpy(
                (x.astype(np.float32) - 127.5) / 127.5)})
    lab = np.zeros_like(lab)
    for i in range(BATCH):
        rows = dets_to_rows(bx[i].numpy(), sc[i].numpy())
        rows = rows[np.argsort(-rows[:, 4], kind="stable")][:3]
        rows = rows[rows[:, 0] > 0]
        for t, r in enumerate(rows):
            lab[i, 5 * t:5 * t + 5] = [r[0], r[1], r[2], r[3], r[5]]
        assert len(rows), i
    buf = np.memmap(erec, np.uint8, mode="r+")
    rec = loader._rec
    img = loader.c * loader.h * loader.w
    for i in range(BATCH):
        at = loader._hdr + i * rec + img
        buf[at:at + lab.shape[1] * 4] = np.frombuffer(
            lab[i].astype("<f4").tobytes(), np.uint8)
    buf.flush()
    del buf


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """The soak's records and checkpoint, both packages' record sets
    compared, the held-out labels rewritten; then the port's study with
    its trace."""
    from bcnn_tpu_torch import Mode, bridge
    from examples_torch import train_soak

    tool = _load(os.path.join(ROOT, "tools", "int8_map_study_torch.py"),
                 "int8_map_study_torch")
    base = tmp_path_factory.mktemp("int8_study")
    data, run = str(base / "data"), str(base / "run")
    train_soak.main(["--batch", str(BATCH), "--scan", "2", "--size",
                     str(SIZE), "--src-size", str(SRC), "--images",
                     str(IMAGES), "--steps", "4", "--act", "fp32",
                     "--eval-every", "0", "--ckpt-every", "0", "--dir", run,
                     "--outdir", data, "--device", "cpu"],
                    weights=bridge.he_numpy_weights(
                        tool.yolo_net(BATCH, SIZE, Mode.TRAIN), 0))
    rec = os.path.join(data, f"soakl_{SIZE}_n{IMAGES}.bcrd")
    erec = os.path.join(data, f"soakl_eval_{SIZE}_n{BATCH}.bcrd")
    # bcnn_tpu's own record sets of the same task: byte for byte
    jdata = str(base / "jdata")
    _jax_records(jdata)
    for p in (rec, erec):
        with open(p, "rb") as a, open(os.path.join(
                jdata, os.path.basename(p)), "rb") as b:
            assert a.read() == b.read(), p
    ckpt = os.path.join(run, "ckpt_latest.npz")
    _own_labels(erec, ckpt)
    trace = {}
    out = tool.main(["--ckpt", ckpt, "--outdir", data] + STUDY,
                    trace=trace)
    return dict(out=out, trace=trace, ckpt=ckpt, rec=rec, erec=erec)


def _jax_records(outdir):
    """examples/train_soak.py's records of the same task (bcnn_tpu's
    write_dataset and records_from_loader), as make_records writes
    them."""
    from bcnn_tpu import Mode
    from bcnn_tpu.data import records_from_loader
    from bcnn_tpu.data.loaders import DetectionListLoader
    from bcnn_tpu.models import yolov3_tiny

    write_dataset = _load(os.path.join(ROOT, "examples",
                                       "train_throughput.py"),
                          "jax_train_throughput").write_dataset

    os.makedirs(outdir, exist_ok=True)
    net = yolov3_tiny(batch_size=BATCH, width=SIZE, height=SIZE,
                      mode=Mode.VALID)
    lst = write_dataset(outdir, IMAGES, SRC, int(SRC * 0.75))
    records_from_loader(DetectionListLoader(net, lst), os.path.join(
        outdir, f"soakl_{SIZE}_n{IMAGES}.bcrd"), IMAGES)
    edir = os.path.join(outdir, "eval")
    os.makedirs(edir, exist_ok=True)
    elst = write_dataset(edir, BATCH, SRC, int(SRC * 0.75), seed=999)
    records_from_loader(DetectionListLoader(net, elst), os.path.join(
        outdir, f"soakl_eval_{SIZE}_n{BATCH}.bcrd"), BATCH)


@pytest.fixture(scope="module")
def reference(study):
    """tools/int8_map_study.py's stages composed of bcnn_tpu's functions
    on the same checkpoint and records, with their products."""
    from bcnn_tpu import Mode, Session
    from bcnn_tpu.checkpoint import load_checkpoint
    from bcnn_tpu.compile import make_detect_fn, make_train_scan
    from bcnn_tpu.data import RawRecordLoader
    from bcnn_tpu.models import yolov3_tiny
    from bcnn_tpu.ops.quant import calibrate, quantize_weights

    jtool = _load(os.path.join(ROOT, "tools", "int8_map_study.py"),
                  "int8_map_study")

    def tiny(batch, mode, compute=None):
        net = yolov3_tiny(batch_size=batch, width=SIZE, height=SIZE,
                          mode=mode)
        net.compute_dtype = compute
        return net

    params, state, _, _ = load_checkpoint(study["ckpt"])
    el = RawRecordLoader(tiny(BATCH, Mode.VALID), study["erec"])
    xe_u8, ye = el.next_batch()
    el.close()
    xe = jnp.asarray((xe_u8.astype(np.float32) - 127.5) / 127.5)
    tl = RawRecordLoader(tiny(4, Mode.VALID), study["rec"])
    calib = [(tl.next_batch()[0].astype(np.float32) - 127.5) / 127.5
             for _ in range(BATCH // 4)]
    tl.close()
    out = {"eval": (xe_u8, ye), "ptq": {}, "heads": {}}
    net = tiny(BATCH, Mode.PREDICT)
    detect = jax.jit(make_detect_fn(net, thresh=0.005, max_dets=100))
    out["fp32"] = jtool.map50_of(detect, params, state, xe, ye)
    heads = [n.src[0] for n in net.nodes if n.type.name == "YOLOV3"]
    for method in ("absmax", "percentile", "kl"):
        netq = tiny(BATCH, Mode.PREDICT)
        netq.quant = {"act_scales": calibrate(netq, params, state, calib,
                                              method=method),
                      "weights": quantize_weights(netq, params)}
        out["ptq"][method] = netq.quant
        detq = jax.jit(make_detect_fn(netq, thresh=0.005, max_dets=100))
        out[f"ptq_{method}"] = jtool.map50_of(detq, params, state, xe, ye)
        sess = Session(netq, seed=0).compile_net()
        sess.params, sess.state = params, state
        names = [netq.tensors[i].name for i in heads]
        got, _ = sess.predict_on_batch(np.asarray(xe), outputs=names)
        out["heads"][method] = [np.asarray(g) for g in got]

    nett = tiny(4, Mode.TRAIN)
    nett.set_sgd_optimizer(learning_rate=1e-4, momentum=0.9)
    nett.qat = True
    nett.device_augment = {"random_fliph": 0}
    sess = Session(nett, seed=0).compile_net()
    for k, v in params.items():  # copies: the scan donates its trees
        sess.params[k] = jnp.array(v)
    for k, v in state.items():
        if k in sess.state:
            sess.state[k] = jnp.array(v)
    loader = RawRecordLoader(nett, study["rec"])
    scan = make_train_scan(nett)
    p, s, o = sess.params, sess.state, sess.opt_state
    xs, ys = zip(*(loader.next_batch() for _ in range(5)))
    loader.close()
    p, s, o, _ = scan(p, s, o, {"input": jnp.asarray(np.stack(xs)),
                                "label": jnp.asarray(np.stack(ys))},
                      jax.random.PRNGKey(3))
    sess.params, sess.state, sess.opt_state = p, s, o
    quant = sess.freeze_qat()
    netf = tiny(BATCH, Mode.PREDICT)
    netf.quant = quant
    detf = jax.jit(make_detect_fn(netf, thresh=0.005, max_dets=100))
    pf = {k: np.asarray(v) for k, v in p.items()}
    sf = {k: np.asarray(v) for k, v in s.items() if not k.startswith("qat_")}
    out["qat_fp32"] = jtool.map50_of(detect, pf, sf, xe, ye)
    out["qat_int8"] = jtool.map50_of(detf, pf, sf, xe, ye)
    out["qat_quant"] = quant
    # the JAX study's own setting: the fp32 stage at bf16 compute
    netb = tiny(BATCH, Mode.PREDICT, jnp.bfloat16)
    out["fp32_bf16"] = jtool.map50_of(
        jax.jit(make_detect_fn(netb, thresh=0.005, max_dets=100)),
        params, state, xe, ye)
    return out


def test_the_stages_score_as_bcnn_tpus(study, reference):
    """The JSON line's keys and each stage's mAP against bcnn_tpu's; the
    fp32 stage not degenerate."""
    out = study["out"]
    assert set(out) == {"study", "eval_images", "ckpt", "fp32",
                        "ptq_absmax", "ptq_percentile", "ptq_kl",
                        "qat_fp32", "qat_int8"}
    assert out["eval_images"] == BATCH
    assert out["fp32"] > 0.5
    for key in ("fp32", "ptq_absmax", "ptq_percentile", "ptq_kl",
                "qat_fp32", "qat_int8"):
        assert abs(out[key] - reference[key]) <= MAP_TOL, (
            key, out[key], reference[key])


def test_the_bf16_default_scores_as_bcnn_tpus(study, reference):
    """At the default --compute bf16 (the JAX study's setting) the fp32
    stage's mAP against bcnn_tpu's at bf16 compute."""
    tool = _load(os.path.join(ROOT, "tools", "int8_map_study_torch.py"),
                 "int8_map_study_torch")
    argv = ["--ckpt", study["ckpt"], "--outdir",
            os.path.dirname(study["rec"]), "--stages", "fp32"]
    out = tool.main(argv + [a for a in STUDY if a not in ("--compute",
                                                           "fp32")])
    assert out["fp32"] > 0.5
    assert abs(out["fp32"] - reference["fp32_bf16"]) <= MAP_TOL


def test_the_eval_batch_is_bcnn_tpus(study, reference):
    for a, b in zip(study["trace"]["eval"], reference["eval"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["absmax", "percentile", "kl"])
def test_calibration_and_int8_weights(study, reference, method):
    """Each method's activation scales (absmax and percentile within rtol
    1e-5, KL equal), the int8 weights code for code, and the int8 heads
    of the held-out batch within HEAD_TOL of bcnn_tpu's."""
    from bcnn_tpu_torch import Mode, bridge
    from bcnn_tpu_torch.checkpoint import load_checkpoint
    from bcnn_tpu_torch.compile import execute, output_value

    got = study["trace"]["ptq"][method]
    want = reference["ptq"][method]
    assert set(got["act_scales"]) == set(want["act_scales"])
    for i, v in want["act_scales"].items():
        np.testing.assert_allclose(got["act_scales"][i], float(v),
                                   rtol=SCALE_RTOL, err_msg=str(i))
    if method == "kl":  # and its scale with the range's rounding
        # the KL thresholds: the clip bin of 2048 over each range's
        # abs-max (the absmax method's scale times 127), equal
        def cut(scales):
            return {i: round(scales[i] / absmax[i] * 2048 - 0.5)
                    for i in scales}

        absmax = study["trace"]["ptq"]["absmax"]["act_scales"]
        mine = cut(got["act_scales"])
        absmax = {k: float(v) for k, v in
                  reference["ptq"]["absmax"]["act_scales"].items()}
        theirs = cut({k: float(v) for k, v in want["act_scales"].items()})
        assert mine == theirs
    tool = _load(os.path.join(ROOT, "tools", "int8_map_study_torch.py"),
                 "int8_map_study_torch")
    net = tool.yolo_net(BATCH, SIZE, Mode.PREDICT, "fp32")
    ref_w = bridge.quant_from_numpy(net, {"act_scales": {}, "weights":
                                          jax.tree.map(np.asarray,
                                                       want["weights"])})
    for k, e in got["weights"].items():
        for part in ("q", "scale"):
            assert torch.equal(e[part], ref_w["weights"][k][part]), (k, part)
    net.quant = got
    params, state, _, _ = load_checkpoint(net, study["ckpt"], "cpu")
    xe = torch.from_numpy((study["trace"]["eval"][0].astype(np.float32)
                           - 127.5) / 127.5)
    heads = [n.src[0] for n in net.nodes if n.type.name == "YOLOV3"]
    with torch.inference_mode():
        ex = execute(net, params, state, {"input": xe}, Mode.PREDICT)
        for i, r in zip(heads, reference["heads"][method]):
            g = output_value(ex, i).float().numpy()
            assert np.abs(r).max() > 0
            assert np.abs(g - r).max() <= HEAD_TOL * np.abs(r).max()


def test_qat_freezes_as_bcnn_tpus(study, reference):
    """The fine-tuned, frozen quant dict: the same activations watched and
    weights quantized, each scale within QAT_RTOL of bcnn_tpu's (the
    ranges are EMAs of the activations of 5 bf16 steps, each package's
    own)."""
    got = study["trace"]["qat"]["quant"]
    want = reference["qat_quant"]
    assert set(got["act_scales"]) == set(want["act_scales"])
    for i, v in want["act_scales"].items():
        np.testing.assert_allclose(got["act_scales"][i], float(v),
                                   rtol=QAT_RTOL, err_msg=str(i))
    assert set(got["weights"]) == set(want["weights"])
