#!/usr/bin/env python3
"""Registers and spills of each kernel of the port's CUDA libraries, as
``ptxas`` reports them: each ``csrc/<name>.cu`` compiled with the build's
own flags (``tpu_resnet_torch/ops/_build.py`` ``NVCC_FLAGS``) and
``-Xptxas -v`` into a temporary directory. Needs ``nvcc``; no card.

    python3 tools/torch_ptxas_report.py [--root DIR] [--match REGEX] \
        [--tag NAME] [name ...]

``name``: the libraries (default: ``fused_block_tc``). ``--root``: the
checkout whose sources compile (default: this one), so that a parent commit
unpacked into an ignored directory reports beside the change.
``--match``: only the kernels whose demangled name matches. Prints one JSON
line a library: each kernel's registers, stack frame and spill bytes
(stores and loads), its name demangled by ``c++filt`` where there is one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

_ENTRY = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Compiling entry function '(\S+)'|Used (\d+) registers")


def parse(log: str) -> dict:
    """{mangled name: {registers, stack_bytes, spill_store_bytes,
    spill_load_bytes}} from ``ptxas -v``'s report."""
    out, name, entry = {}, None, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            continue
        m = _FRAME.search(line)
        if m and name:
            out.setdefault(name, {}).update(
                stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                spill_load_bytes=int(m.group(3)))
            name = None
            continue
        m = _REGS.search(line)
        if m and m.group(1):
            entry = m.group(1)
        elif m and entry:
            out.setdefault(entry, {})["registers"] = int(m.group(2))
            entry = None
    return out


def demangle(names):
    tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    proc = subprocess.run([tool], input="\n".join(names), capture_output=True,
                          text=True, check=True)
    return [n.replace("(anonymous namespace)::", "")
            for n in proc.stdout.splitlines()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=["fused_block_tc"])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--match", default="")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from tpu_resnet_torch.ops import _build
    nvcc = _build._nvcc()
    pattern = re.compile(args.match)
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.names:
            src = os.path.join(root, "tpu_resnet_torch", "csrc", f"{name}.cu")
            proc = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 os.path.join(tmp, f"{name}.so"), src], capture_output=True,
                text=True)
            if proc.returncode:
                print(proc.stderr[-4000:], file=sys.stderr)
                return 1
            found = parse(proc.stdout + proc.stderr)
            kernels = [dict(name=shown, **found[mangled])
                       for mangled, shown in zip(found, demangle(list(found)))
                       if pattern.search(shown)]
            print(json.dumps({"tag": args.tag, "root": root, "library": name,
                              "kernels": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
