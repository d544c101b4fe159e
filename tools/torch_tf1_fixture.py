#!/usr/bin/env python3
"""Write the tiny TF1 checkpoint that the port's TF1 reader is tested on.

    python tools/torch_tf1_fixture.py [--out tests/fixtures/tf1_madnet_tiny]

Needs TensorFlow (``tf.compat.v1.train.Saver``, a V2 tensor bundle). Writes
``model.ckpt.index``, ``model.ckpt.data-00000-of-00001`` and ``checkpoint``
into ``--out``, and ``values.npz``: the same tensors under the same names
(with ``/`` kept), so that a reader without TensorFlow can be held to
them bit for bit. The variables are a few of MADNet's under the names the
reference gives them (scope ``model``): the pyramid's first conv, the
scale-2 estimator's last conv and the context net's last conv, seeded
float32 values; about 10 KB in all.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
# reference name -> shape (HWIO weights, biases)
VARIABLES = {
    "model/gc-read-pyramid/conv1/weights": (3, 3, 3, 16),
    "model/gc-read-pyramid/conv1/biases": (16,),
    "model/G2/fgc-volume-filtering-2/disp-6/weights": (3, 3, 32, 1),
    "model/G2/fgc-volume-filtering-2/disp-6/biases": (1,),
    "model/context-7/weights": (3, 3, 32, 1),
    "model/context-7/biases": (1,),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "fixtures" / "tf1_madnet_tiny"))
    args = ap.parse_args()
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
    import tensorflow as tf

    tf1 = tf.compat.v1
    rng = np.random.default_rng(15)
    values = {name: rng.standard_normal(shape).astype(np.float32) for name, shape in VARIABLES.items()}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    g = tf1.Graph()
    with g.as_default():
        for name, value in values.items():
            tf1.get_variable(name, initializer=value)
        saver = tf1.train.Saver()
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            prefix = saver.save(sess, str(out / "model.ckpt"), write_meta_graph=False)
    # the checkpoint state file names the prefix relative to its directory
    (out / "checkpoint").write_text(
        'model_checkpoint_path: "model.ckpt"\nall_model_checkpoint_paths: "model.ckpt"\n'
    )
    np.savez(out / "values.npz", **values)
    print(f"wrote {prefix} and {out / 'values.npz'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
