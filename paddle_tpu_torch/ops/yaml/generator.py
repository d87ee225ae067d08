"""Code generator: ops.yaml -> paddle_tpu_torch/_C_ops.py (the port of
``paddle_tpu/ops/yaml/generator.py``).

Reference analog: paddle/phi/api/generator/python_c_gen.py generates the
`core.eager.ops.*` pybind functions surfaced as `paddle._C_ops`
(python/paddle/_C_ops.py:20). Here the generated surface is a flat Python
module binding every schema'd op (plus declared inplace variants and
op_compat legacy aliases) to its kernel entry point in paddle_tpu_torch.

Run:  python -m paddle_tpu_torch.ops.yaml.generator          # rewrites _C_ops.py
      python -m paddle_tpu_torch.ops.yaml.generator --check  # verify up to date
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_PATH = os.path.join(HERE, "..", "..", "_C_ops.py")

HEADER = '''"""paddle_tpu_torch._C_ops — generated op dispatch surface.

AUTO-GENERATED by paddle_tpu_torch/ops/yaml/generator.py from
paddle_tpu_torch/ops/yaml/ops.yaml — DO NOT EDIT BY HAND.

Reference analog: paddle._C_ops (python/paddle/_C_ops.py:20), the flat
namespace of generated Python-C bindings (python_c_gen.py:113). Each
binding resolves, on its first call, to the op library entry whose body is
torch ops dispatched through paddle_tpu_torch.core.dispatch.run_op (AMP,
autograd through torch's, NaN check).
"""
from __future__ import annotations

import importlib as _importlib

_cache = {}


def _bind(path):
    mod, fn = path.rsplit(".", 1)
    key = (mod, fn)
    if key not in _cache:
        _cache[key] = getattr(_importlib.import_module(mod), fn)
    return _cache[key]

'''


def _load(name):
    import yaml
    with open(os.path.join(HERE, name)) as f:
        return yaml.safe_load(f) or []


def load_schemas() -> List[Dict]:
    return _load("ops.yaml")


def load_compat() -> Dict[str, str]:
    return {e["op"]: e["legacy"] for e in _load("op_compat.yaml")}


def generate() -> str:
    schemas = load_schemas()
    compat = load_compat()
    lines = [HEADER]
    names = []
    for s in schemas:
        op = s["op"]
        kernel = s["kernel"]["func"]
        mod = kernel.rsplit(".", 1)[0]
        lines.append(f"def {op}(*args, **kwargs):")
        lines.append(f"    return _bind('{kernel}')(*args, **kwargs)")
        lines.append("")
        names.append(op)
        if "inplace" in s:
            ip = op + "_"
            lines.append(f"def {ip}(*args, **kwargs):")
            lines.append(f"    return _bind('{mod}.{ip}')(*args, **kwargs)")
            lines.append("")
            names.append(ip)
        if op in compat:
            lines.append(f"{compat[op]} = {op}  # op_compat.yaml legacy name")
            lines.append("")
            names.append(compat[op])
    lines.append("__all__ = [")
    for n in sorted(names):
        lines.append(f"    {n!r},")
    lines.append("]")
    lines.append("")
    return "\n".join(lines)


def main(argv):
    text = generate()
    out = os.path.normpath(OUT_PATH)
    if "--check" in argv:
        with open(out) as f:
            on_disk = f.read()
        if on_disk != text:
            print("_C_ops.py is out of date; rerun the generator",
                  file=sys.stderr)
            return 1
        print("_C_ops.py up to date")
        return 0
    with open(out, "w") as f:
        f.write(text)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
