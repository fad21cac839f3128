"""The plain reference against the port on the CPU at small input
sizes: heads at each precision, the int8
scheme's calibration and flow plan, and the detection stage."""

import pytest
import torch

from benchmark import check, harness
from benchmark.program import Served
from benchmark.reference import darknet, detect
from bm_cells import small_cell

torch.set_num_threads(2)

CELLS = {"yolov3-416": "yolov3-416.detect-int8.b64"}
# the widest relative error of a head, ||p - r|| / ||r||, at 64 px: fp32
# differs by the order of its sums; bf16 by its rounding of every stored
# activation; int8 where a code's rounding flips on a last-place
# difference and the flip travels down the net (full YOLOv3: 75 convs)
TOL = {("yolov3-416", "fp32"): 1e-5, ("yolov3-416", "bf16"): 0.05,
       ("yolov3-416", "int8"): 0.15}


def built(config, prec, seed=5):
    with small_cell(CELLS[config], size=64, batch=2) as (tag, _):
        cell = harness.load_cell(tag)
    cell["precision"] = prec
    layers, weights, calib, pool = harness.make_inputs(cell, seed, "cpu")
    served = Served(cell["cfg"], cell, weights, calib.numpy(), "cpu")
    return cell, layers, weights, calib, pool, served


@pytest.mark.parametrize("config, prec", sorted(TOL))
def test_heads_agree(config, prec):
    cell, layers, weights, calib, pool, served = built(config, prec)
    quant = darknet.calibrate(layers, weights, calib) if prec == "int8" \
        else None
    x = torch.as_tensor(pool[0])
    ref = check.ref_heads(cell["ref"], layers, weights, x, prec, quant, 2)
    assert check.head_gap(served.heads(pool[0]), ref) < TOL[config, prec]


@pytest.mark.parametrize("config", sorted(CELLS))
def test_int8_scales_and_plan_agree(config):
    from bcnn_tpu_torch.ops.quant import plan_int8_flow

    cell, layers, weights, calib, pool, served = built(config, "int8")
    quant = darknet.calibrate(layers, weights, calib)
    net = served.net
    lid = lambda i: int(net.tensors[i].name[3:]) - 1 \
        if net.tensors[i].name.startswith("lid") else -1  # noqa: E731
    prog_act = {lid(i): s for i, s in net.quant["act_scales"].items()}
    assert sorted(prog_act) == sorted(quant.act)
    for t, s in quant.act.items():
        assert abs(prog_act[t] / s - 1) < 1e-5
    prog_flow = {lid(i): s for i, s in plan_int8_flow(net, net.quant).items()}
    assert sorted(prog_flow) == sorted(quant.flow)
    # the plan read with one shared scale is the largest plan
    largest = darknet.plan_flow(
        layers, {t: 1.0 for t in darknet.watch_tensors(layers)})
    assert set(largest) >= set(quant.flow)
    for k, wq in enumerate(quant.wq):
        key = [n for n in net.nodes if n.type.name == "CONV2D"][k]
        pq = net.quant["weights"][net.tensors[key.src[1]].key]["q"]
        assert torch.equal(pq.to(torch.float64), wq)


@pytest.mark.parametrize("prec", ["fp32", "bf16", "int8"])
def test_detections_follow_the_heads(prec):
    cell, layers, weights, calib, pool, served = built("yolov3-416", prec)
    out = served.detect(pool[0])
    heads = served.heads(pool[0])
    params = [p for _, p in darknet.heads(layers)]
    d = cell["detect"]
    margins = harness.load_cell(
        "yolov3-416.detect-bf16.b64" if prec == "bf16"
        else "yolov3-416.detect-int8.b64")["check"]["margins"]
    gap, faults = check.det_numbers(cell["ref"], out, heads, params, 64, 64,
                                    d["max_dets"], d["thresh"], margins)
    # the port decodes bf16 heads in bf16 (an objectness or score within
    # 2^-8 of its value, a box within 2^-8 relatively)
    assert gap < (0.02 if prec == "bf16" else 1e-5)
    assert faults == 0
    # the reference's own detections from the same heads: the same rows,
    # a rounding at the threshold or NMS's IoU limit aside in bf16
    ref = detect.detections(heads, params, 64, 64, d["max_dets"],
                            d["thresh"])
    diff = ((ref[2] > 0).sum(1) - (out[2] > 0).sum(1)).abs().max()
    assert int(diff) <= (3 if prec == "bf16" else 0)


def test_the_selection_rule_is_greedy_nms_without_margins():
    """With no margins, the reference's own detections pass and any
    other set of rows fails."""
    cell, layers, weights, calib, pool, served = built("yolov3-416", "fp32")
    heads = served.heads(pool[0])
    params = [p for _, p in darknet.heads(layers)]
    d = cell["detect"]
    none = {"sigmoid": 0.0, "exp": 0.0}
    ref = detect.detections(heads, params, 64, 64, d["max_dets"],
                            d["thresh"])
    gap, faults = check.det_numbers(cell["ref"], ref, heads, params, 64, 64,
                                    d["max_dets"], d["thresh"], none)
    assert gap < 1e-6 and faults == 0
    for drop in (0, -1):
        obj = ref[2].clone()
        kept = (obj[0] > 0).nonzero().flatten()
        obj[0, kept[drop]] = 0
        _, faults = check.det_numbers(cell["ref"], (ref[0], ref[1], obj),
                                      heads, params, 64, 64, d["max_dets"],
                                      d["thresh"], none)
        assert faults >= 1


def test_lower_precision_fails_where_the_program_passes():
    """The control at 64 px: the reference at int4 in the int8 program's
    place reads far above the program."""
    cell, layers, weights, calib, pool, served = built("yolov3-416", "int8")
    x = torch.as_tensor(pool[0])
    ref = check.ref_heads(cell["ref"], layers, weights, x, "int8",
                          darknet.calibrate(layers, weights, calib), 2)
    low = check.ref_heads(cell["ref"], layers, weights, x, "int8",
                          darknet.calibrate(layers, weights, calib, bits=4), 2)
    prog = check.head_gap(served.heads(pool[0]), ref)
    assert check.head_gap(low, ref) > 3 * max(prog, 1e-4)
