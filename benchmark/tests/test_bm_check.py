"""The check's match of a served row to its candidate on the CPU: two
candidates whose boxes lie within 2e-4 of each other and whose class
scores differ."""

import torch

from benchmark import check, harness

E = "yolov3-416.detect-bf16.b64"
SIZE = 64
# one head of one grid cell, two anchors 1e-4 apart in width, three
# classes
PARAMS = [{"num": 2, "classes": 3, "anchors": [10.0, 10.0, 10.001, 10.0],
           "mask": [0, 1]}]


def near_tie():
    """(heads, served): candidates 0 and 1 share their box to 1.6e-5
    and their objectness; the served row is candidate 1, its box rounded
    onto candidate 0's."""
    raw = torch.zeros(1, 2, 8, 1, 1)  # (N, anchor, 5 + classes, H, W)
    raw[:, :, 4] = 2.0
    raw[0, 0, 5:, 0, 0] = torch.tensor([3.0, -3.0, 0.0])
    raw[0, 1, 5:, 0, 0] = torch.tensor([-3.0, 3.0, 0.0])
    heads = [raw.reshape(1, 16, 1, 1)]
    ref = harness.load_cell(E)["ref"]
    boxes, objl, clsl = ref.decode(heads, PARAMS, SIZE, SIZE)
    p = torch.sigmoid(objl)
    served = (torch.zeros(1, 2, 4), torch.zeros(1, 2, 3), torch.zeros(1, 2))
    served[0][0, 0] = boxes[0, 0]
    served[1][0, 0] = p[0, 1] * torch.sigmoid(clsl[0, 1])
    served[2][0, 0] = p[0, 1]
    return heads, served, (boxes[0], p[0], p[0][:, None]
                           * torch.sigmoid(clsl[0]))


def numbers(heads, served):
    cell = harness.load_cell(E)
    d = cell["detect"]
    return check.det_numbers(cell["ref"], served, heads, PARAMS, SIZE, SIZE,
                             d["max_dets"], d["thresh"],
                             cell["check"]["margins"])


def test_the_whole_gap_picks_the_row_of_a_near_tie():
    heads, served, (rb, rp, rs) = near_tie()
    limit = harness.load_cell(E)["check"]["limits"]["dets"]
    assert float((rb[0] - rb[1]).abs().max()) < 2e-4
    # the nearest by box and objectness alone is the wrong candidate,
    # and its class scores read far over the limit
    b, o, s = served[0][0, :1], served[2][0, :1], served[1][0, :1]
    d = torch.maximum((b[:, None] - rb[None]).abs().amax(-1),
                      (o[:, None] - rp[None]).abs())
    assert int(d.argmin()) == 0
    assert float((s - rs[0]).abs().max()) > limit
    gap, c = check.match(b, o, s, rb, rp, rs)
    assert c.tolist() == [1]
    dets, select = numbers(heads, served)
    assert dets < 1e-4 and select == 0


def test_a_score_fault_on_a_near_tie_still_fails():
    heads, served, _ = near_tie()
    limit = harness.load_cell(E)["check"]["limits"]["dets"]
    scores = served[1].clone()
    scores[0, 0, 2] += 0.3
    dets, _ = numbers(heads, (served[0], scores, served[2]))
    assert dets > limit
