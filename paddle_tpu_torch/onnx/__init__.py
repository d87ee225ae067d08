"""paddle.onnx (reference: python/paddle/onnx/export.py, which delegates
to paddle2onnx).

Port of ``paddle_tpu/onnx/__init__.py``, which writes the jitted program's
StableHLO text. The port writes the traced program's graph text instead:
the ``torch.export`` graph of the layer at ``input_spec``, as ``jit.save``
writes beside its program (a deliberate difference, ROADMAP). ONNX-proto
emission needs the (absent) onnx package."""
from __future__ import annotations

import os


def export(layer, path, input_spec=None, opset_version=9, **configs):
    from ..jit import _export
    ep = _export(layer, input_spec or [])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out_path = path if path.endswith(".txt") else path + ".graph.txt"
    with open(out_path, "w") as f:
        f.write(str(ep.graph))
    return out_path


__all__ = ["export"]
