"""Registers, static shared memory and spills of every kernel in
``csrc/``, as ``ptxas -v`` reports them when the sources compile with the
library's own ``nvcc`` flags.  ``--against DIR`` compiles the ``.cu``
files of another ``csrc`` directory (an older checkout) too and prints the
two side by side, so a change to one instantiation can be checked for
moving the others.  Dynamic shared memory is set at launch and does not
show here.  Needs ``nvcc``; no card.

    python3 -m protosam_tpu_torch.tools.ptxas_report [--against DIR]
"""

from __future__ import annotations

import argparse
import pathlib
import re
import shutil
import subprocess
import tempfile

from protosam_tpu_torch import kernels

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse(ptxas_out: str) -> dict[str, dict]:
    """Mangled kernel name -> registers, smem, spill store/load bytes."""
    out, name = {}, None
    for line in ptxas_out.splitlines():
        if m := _ENTRY.search(line):
            name = m.group(1)
            out[name] = {"registers": 0, "smem": 0, "spill": (0, 0)}
        elif name is None:
            continue
        elif m := _SPILL.search(line):
            out[name]["spill"] = (int(m.group(1)), int(m.group(2)))
        elif m := _USED.search(line):
            out[name]["registers"] = int(m.group(1))
            if s := _SMEM.search(line):
                out[name]["smem"] = int(s.group(1))
    return out


def report(csrc: pathlib.Path) -> dict[str, dict]:
    """Compile every ``.cu`` of ``csrc`` with ``-Xptxas -v``."""
    nvcc, out = kernels._nvcc(), {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(csrc.glob("*.cu")):
            proc = subprocess.run(
                [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(csrc),
                 "-c", str(src), "-o", str(pathlib.Path(tmp) / "k.o")],
                capture_output=True, text=True, check=True)
            for name, v in parse(proc.stdout + proc.stderr).items():
                out[name] = {**v, "file": src.name}
    return out


def demangle(names: list[str]) -> dict[str, str]:
    tool = shutil.which("c++filt")
    if tool is None:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", default=None,
                    help="another csrc directory to compile and list beside")
    args = ap.parse_args(argv)
    tables = {"this tree": report(kernels.CSRC_DIR)}
    if args.against:
        tables["against"] = report(pathlib.Path(args.against))
    for label, table in tables.items():
        names = demangle(sorted(table))
        print(f"== ptxas -v, {label} ({len(table)} kernels): registers, "
              f"static smem bytes, spill store/load bytes", flush=True)
        for mangled, pretty in sorted(names.items(), key=lambda kv: kv[1]):
            v = table[mangled]
            print(f"{v['registers']:4d} regs {v['smem']:7d} smem "
                  f"spill {v['spill'][0]}/{v['spill'][1]}  {v['file']}  "
                  f"{pretty}", flush=True)
    return tables


if __name__ == "__main__":
    main()
