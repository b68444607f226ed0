#!/usr/bin/env python3
"""Time named kernel cases of ``chip_smoke.py`` on two trees of the port,
in turns, on one NVIDIA GPU.

    python3 kernel_ab.py PARENT CHANGE CASE [CASE ...]

PARENT and CHANGE are the roots of two checkouts of the repository (for
example the parent commit unpacked with ``git archive`` under the
gitignored ``build/``). A CASE is a key of ``chip_smoke.KERNEL_CASES``,
optionally with integer options: ``a6_grouped:chunks=16`` runs that
case with ``chunks=16``. The turns go parent, change, change, parent.
Each turn is a process of its own, since both trees' packages are named
``trino_tpu_torch``: it puts its tree's root first on ``sys.path``,
builds that tree's kernels into the tree's ``build/torch_kernels/``, and
runs every case on the tree's wrappers with the ``chip_smoke.py``
beside this script (the same inputs for both trees): each kernel is
held against its plain version, then timed with CUDA events. The case
runs once more under ``torch.profiler``, which gives the device time a
launch of each of the port's CUDA kernels in it. Prints one JSON line
per turn and, last, a JSON object of each case's kernel ms per turn.
Exits non-zero if a turn fails.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
#: the port's own CUDA kernels (every csrc/*.cu keeps them in an
#: anonymous namespace, as some of PyTorch's own do)
OWN_KERNEL = "(anonymous namespace)::"
_KERNEL_DEF = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parse_case(arg: str) -> tuple[str, dict]:
    """``name`` or ``name:key=value,...`` (integer values)."""
    name, _, opts = arg.partition(":")
    options = {}
    for item in filter(None, opts.split(",")):
        key, _, value = item.partition("=")
        options[key] = int(value)
    return name, options


def kernel_names(tree: str) -> set[str]:
    """The names of the ``__global__`` functions in a tree's
    ``trino_tpu_torch/csrc/*.cu``."""
    csrc = os.path.join(tree, "trino_tpu_torch", "csrc")
    names = set()
    for f in os.listdir(csrc):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as src:
                names.update(_KERNEL_DEF.findall(src.read()))
    return names


def own_kernel(key: str, names: set[str]) -> str | None:
    """The name (with its template arguments) of one of the port's CUDA
    kernels ``names`` from a profiler key, or None for anything else. A
    template kernel's key starts with its return type, ``void``."""
    key = key.removeprefix("void ")
    if not key.startswith(OWN_KERNEL):
        return None
    name = key[len(OWN_KERNEL):].split("(")[0]
    return name if name.split("<")[0] in names else None


def _device_us(torch, fn, names: set[str]) -> dict:
    """Device time (us) a launch, and launches, of each of the port's
    CUDA kernels ``names`` in one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = own_kernel(e.key, names)
        if name is None:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        out[name] = {"us": round(us / max(e.count, 1), 1), "launches": e.count}
    return out


def turn(tree: str, cases: list[str]) -> dict:
    """Every case on the wrappers of the tree at ``tree``."""
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from trino_tpu_torch.exec import kernels as K
    from trino_tpu_torch.exec import native, shapes

    cs = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    native.build_all()
    names = kernel_names(tree)
    dev = torch.device("cuda")
    out = {"tree": tree}
    for arg in cases:
        name, options = parse_case(arg)
        run = cs.KERNEL_CASES[name]
        out[arg] = run(torch, np, K, shapes, dev, **options)
        out[arg]["kernels_us"] = _device_us(
            torch, lambda: run(torch, np, K, shapes, dev, **options), names)
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--turn":
        print(json.dumps(turn(argv[1], argv[2:])), flush=True)
        return 0
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change, cases = argv[0], argv[1], argv[2:]
    known = _chip_smoke().KERNEL_CASES
    unknown = [c for c in cases if parse_case(c)[0] not in known]
    if unknown:
        print(f"kernel_ab: unknown cases {unknown}; known: {sorted(known)}",
              file=sys.stderr)
        return 2
    table = {c: {"parent": [], "change": []} for c in cases}
    for label, tree in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", tree, *cases],
            capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(proc.stdout[-4000:])
            print(f"kernel_ab: the {label} turn failed ({proc.returncode})",
                  file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{label} " + json.dumps(res), flush=True)
        for c in cases:
            table[c][label].append(res[c]["ms"])
    print(json.dumps(table), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
