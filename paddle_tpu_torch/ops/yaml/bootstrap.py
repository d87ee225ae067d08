"""Bootstrap tool: reflect the op library into ops.yaml schemas (the port
of ``paddle_tpu/ops/yaml/bootstrap.py``).

Reference analog: paddle/phi/ops/yaml/ops.yaml is the hand-maintained
single source of truth. The port's ops.yaml is its own copy of the
reference's schemas; this tool prints what the port's op library itself
declares, for review against that copy (the same invariant as
tests/test_torch_op_schema.py checks: the library conforms to the yaml).

Run:  python -m paddle_tpu_torch.ops.yaml.bootstrap > /tmp/ops.yaml
"""
from __future__ import annotations

import importlib
import inspect
import sys

MODULES = ["math", "manipulation", "creation", "logic", "search", "linalg",
           "random"]

# nn functional ops are schema'd too (reference ops.yaml holds softmax,
# relu, conv2d, ... alongside tensor math)
NN_MODULES = [
    "paddle_tpu_torch.nn.functional.activation",
    "paddle_tpu_torch.nn.functional.common",
    "paddle_tpu_torch.nn.functional.conv",
    "paddle_tpu_torch.nn.functional.loss",
    "paddle_tpu_torch.nn.functional.norm",
    "paddle_tpu_torch.nn.functional.pooling",
]

SKIP = {"Tensor", "run_op", "run_op_inplace", "broadcast_shape",
        "np_run_lengths", "getitem", "setitem", "index_of"}

# ops whose outputs are index/bool-typed (no vjp; reference marks these
# with no backward: entry in ops.yaml)
NON_DIFF = {
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "is_empty", "is_tensor",
    "isnan", "isinf", "isfinite", "isneginf", "isposinf", "isreal",
    "isclose", "allclose", "equal_all", "argmax", "argmin", "argsort",
    "nonzero", "searchsorted", "bucketize", "bincount", "histogram",
    "histogramdd", "unique", "unique_consecutive", "randint", "randperm",
    "one_hot", "tril_indices", "triu_indices", "count_nonzero", "sign",
    "floor", "ceil", "round", "trunc", "all", "any", "shard_index",
}

MULTI_OUT = {
    "split": "Tensor[](out)", "chunk": "Tensor[](out)",
    "unbind": "Tensor[](out)", "unstack": "Tensor[](out)",
    "tensor_split": "Tensor[](out)", "meshgrid": "Tensor[](out)",
    "broadcast_tensors": "Tensor[](out)",
    "qr": "Tensor(q), Tensor(r)", "svd": "Tensor(u), Tensor(s), Tensor(vh)",
    "eigh": "Tensor(w), Tensor(v)", "eig": "Tensor(w), Tensor(v)",
    "lu": "Tensor(lu), Tensor(pivots), Tensor(info)",
    "lu_unpack": "Tensor(p), Tensor(l), Tensor(u)",
    "lstsq": "Tensor(solution), Tensor(residuals), Tensor(rank), "
             "Tensor(singular_values)",
    "slogdet": "Tensor(sign), Tensor(logdet)",
    "topk": "Tensor(values), Tensor(indices)",
    "kthvalue": "Tensor(values), Tensor(indices)",
    "mode": "Tensor(values), Tensor(indices)",
    "sort": "Tensor(out)", "cummax": "Tensor(out), Tensor(indices)",
    "cummin": "Tensor(out), Tensor(indices)",
    "max": "Tensor(out)", "min": "Tensor(out)",
    "unique": "Tensor(out)", "unique_consecutive": "Tensor(out)",
}

TENSOR_ARGS = {"x", "y", "input", "label", "weight", "bias", "index",
               "indices", "mask", "cond", "condition", "value", "values",
               "updates", "arr", "source", "tensor", "mat1", "mat2", "vec",
               "A", "B"}

TENSOR_LIST_ARGS = {"xs", "tensors", "inputs", "tensor_list"}


def arg_schema(name, param):
    if name in TENSOR_LIST_ARGS:
        ty = "Tensor[]"
    elif name in TENSOR_ARGS:
        ty = "Tensor"
    else:
        ty = "Attr"
    if param.default is inspect.Parameter.empty or ty != "Attr":
        return f"{ty} {name}"
    d = param.default
    if isinstance(d, str):
        d = f"'{d}'"
    return f"{ty} {name}={d}"


def main(out=sys.stdout):
    for line in (
            "# Op schema registry — single source of truth for the _C_ops "
            "surface.",
            "# Fields mirror paddle/phi/ops/yaml/ops.yaml: args, output,",
            "# infer_meta, kernel, inplace, backward. Semantics in the port:",
            "#   kernel.func  : the python op entry (torch ops dispatched by "
            "run_op)",
            "#   backward     : auto_vjp = torch autograd through the kernel;",
            "#                  none = non-differentiable output",
            "#   infer_meta   : explicit fn in paddle_tpu_torch.core."
            "infermeta, or",
            "#                  eval_shape = the kernel run on meta tensors "
            "(infer_via_eval_shape)"):
        print(line, file=out)
    print(file=out)
    from paddle_tpu_torch.core.infermeta import INFER_META
    seen = set()
    all_mods = [(m, f"paddle_tpu_torch.ops.{m}") for m in MODULES] + \
        [(p.rsplit(".", 1)[1], p) for p in NN_MODULES]
    for modname, modpath in all_mods:
        mod = importlib.import_module(modpath)
        names = sorted(n for n, f in vars(mod).items()
                       if callable(f) and not n.startswith("_")
                       and n not in SKIP and not n.endswith("_")
                       and getattr(f, "__module__", "") == modpath)
        for name in names:
            if name in seen:
                continue
            seen.add(name)
            fn = getattr(mod, name)
            try:
                sig = inspect.signature(fn)
            except (TypeError, ValueError):
                continue
            args = [arg_schema(p, prm) for p, prm in sig.parameters.items()
                    if p not in ("name",) and prm.kind not in (
                        inspect.Parameter.VAR_POSITIONAL,
                        inspect.Parameter.VAR_KEYWORD)]
            has_inplace = callable(getattr(mod, name + "_", None))
            meta = INFER_META[name].__name__ if name in INFER_META else \
                "eval_shape"
            print(f"- op : {name}", file=out)
            print(f"  args : ({', '.join(args)})", file=out)
            print(f"  output : {MULTI_OUT.get(name, 'Tensor(out)')}",
                  file=out)
            print(f"  infer_meta :", file=out)
            fmeta = meta if meta != "eval_shape" else "infer_via_eval_shape"
            print(f"    func : {fmeta}", file=out)
            print(f"  kernel :", file=out)
            print(f"    func : {modpath}.{name}", file=out)
            if has_inplace:
                first = args[0].split()[1] if args else "x"
                print(f"  inplace : ({first} -> out)", file=out)
            if name not in NON_DIFF:
                print(f"  backward : auto_vjp", file=out)
            print(file=out)


if __name__ == "__main__":
    main()
