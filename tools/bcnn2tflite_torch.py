"""bcnn2tflite for the PyTorch port: a .conf (or Darknet .cfg) and its
weights to a TFLite flatbuffer, through `bcnn_tpu_torch`.

The counterpart of tools/bcnn2tflite.py: the net is built by the port's
`config.load_net` in PREDICT mode (BatchNorm folded), compiled on the
CPU, and written by `bcnn_tpu_torch.tflite.convert_net`: TensorFlow's
converter where tensorflow imports, else the direct flatbuffer writer
(forced with --direct).

Usage:
  python tools/bcnn2tflite_torch.py <conf> <weights> <out.tflite> [--direct]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv):
    args = [a for a in argv if a != "--direct"]
    backend = "direct" if "--direct" in argv else "auto"
    if len(args) < 4:
        print(
            "Usage: bcnn2tflite_torch.py <conf> <weights> <out.tflite> "
            "[--direct]"
        )
        return 1
    from bcnn_tpu_torch import Net, Session
    from bcnn_tpu_torch.config import load_net
    from bcnn_tpu_torch.tflite import convert_net
    from bcnn_tpu_torch.types import Mode

    net = Net(Mode.PREDICT)
    load_net(net, args[1], args[2])
    sess = Session(net, 0, device="cpu").compile_net()
    convert_net(net, sess.params, sess.state, args[3], backend=backend)
    print(f"wrote {args[3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
