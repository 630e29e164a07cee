"""Static SASS instruction counts of the port's kernels, split by kind: the
integer ALU (IADD3, LOP3, shifts, compares), the FMA pipe (FFMA, FADD, FMUL,
and the integer multiplies IMAD and IMUL, which Hopper issues there), the
other fp32 operations (FMNMX, FSETP, FSEL), MUFU (the special-function
unit: rcp, rsqrt, ex2, lg2, sin, cos), fp64, conversions, memory and the
rest (moves, branches, shuffles, barriers).

For each kernel whose name holds one of the patterns given, the counts of
the whole function and of each loop (a backward branch and the code from
its target up to it), innermost first: the loop over the steps of a path
is where a step's cost can be read (the QE mixing stream draws one Philox
block per two steps, so its PRNG step loop holds two steps; QE-M one a
step).  Counts are static: a branch a lane never takes (sincosf's
large-argument reduction, the QE exponential branch) is counted all the
same, so read them beside the phase costs of ``scripts/phase_costs.py``.

Run on a GPU host, from the repository root (``cuobjdump`` from the CUDA
toolkit, under /usr/local/cuda/bin):

    python3 scripts/sass_counts.py OUT.json [--root DIR] [--kernel qe_price_kernel ...]
        [--dump DIR]

``--root`` names a tree whose package is built (default the repository);
the counts come from its ``libhh_kernels.so``.  ``--dump`` writes each
counted kernel's listing to DIR, one file a kernel.
"""

import argparse
import collections
import json
import pathlib
import re
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
DEFAULT_KERNELS = ("qe_price_kernel", "qem_price_kernel", "qe_greeks_kernel", "heston_euler_kernel",
                   "exact_values_kernel", "qe_values_kernel", "qem_terminal_kernel", "qe_vjp_kernel")

_ALU = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "IMNMX", "LEA", "IABS",
        "POPC", "FLO", "BREV", "PRMT", "SEL", "VIADD", "VIMNMX", "ISCADD", "BMSK", "VABSDIFF",
        "IADD32I", "LOP32I", "ISAD", "PLOP3", "P2R", "R2P"}
_FMA = {"FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I", "IMAD", "IMUL", "IMUL32I", "IDP"}
_FP32 = {"FMNMX", "FSETP", "FSEL", "FSET", "FCHK", "FRND", "FSWZADD"}
_FP64 = {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX"}
_CONVERT = {"F2F", "F2I", "I2F", "I2FP", "F2FP", "I2I", "F2IP"}
_MEM = {"LD", "ST", "LDS", "STS", "LDG", "STG", "LDC", "LDL", "STL", "ATOM", "ATOMS", "ATOMG",
        "RED", "LDSM", "ULDC", "LDGSTS"}
CLASSES = ("alu", "fma", "fp32", "mufu", "fp64", "convert", "mem", "other")

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)"
                   r"\s*([^;]*);")


def op_class(op: str) -> str:
    """The class of an opcode (its base name, without modifiers)."""
    if op == "MUFU":
        return "mufu"
    if op in _FMA:
        return "fma"
    if op in _FP32:
        return "fp32"
    if op in _ALU:
        return "alu"
    if op in _FP64:
        return "fp64"
    if op in _CONVERT:
        return "convert"
    if op in _MEM:
        return "mem"
    return "other"


def functions(sass: str) -> dict:
    """{mangled name: [(address, opcode, modifiers, operands)]} of a
    ``cuobjdump -sass`` listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _LINE.search(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(2), m.group(3), m.group(4).strip()))
    return out


def listing_blocks(sass: str) -> dict:
    """{mangled name: its lines of the listing}."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        if name is not None:
            out[name].append(line)
    return {k: "\n".join(v) + "\n" for k, v in out.items()}


def wanted(name: str, patterns) -> bool:
    """Whether kernel ``name`` (mangled) holds one of ``patterns``."""
    return any(k in name for k in patterns)


def counts(instrs) -> dict:
    c = collections.Counter(op_class(op) for _, op, _, _ in instrs)
    mufu = collections.Counter(op + mods for _, op, mods, _ in instrs if op == "MUFU")
    return {**{k: c.get(k, 0) for k in CLASSES}, "total": len(instrs), "mufu_ops": dict(mufu),
            "imad": sum(op == "IMAD" for _, op, _, _ in instrs)}


def loops(instrs) -> list:
    """The loops of a function, innermost (shortest) first: each backward
    branch's span [target, branch] with its counts."""
    spans = []
    for addr, op, _, args in instrs:
        m = re.match(r"(0x[0-9a-f]+)", args)
        if op == "BRA" and m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    out = []
    for lo, hi in sorted(set(spans), key=lambda s: s[1] - s[0]):
        body = [i for i in instrs if lo <= i[0] <= hi]
        out.append({"from": hex(lo), "to": hex(hi), **counts(body)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--kernel", nargs="*", default=list(DEFAULT_KERNELS))
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from hedgehog_tpu_torch.ops import cuda_lib

    lib, _ = cuda_lib.build_library()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    result = {}
    listings = listing_blocks(sass) if args.dump else {}
    for name, instrs in functions(sass).items():
        if not wanted(name, args.kernel):
            continue
        if args.dump:
            out = pathlib.Path(args.dump)
            out.mkdir(parents=True, exist_ok=True)
            (out / f"{name[:120]}.sass").write_text(listings[name])
        result[name] = {"function": counts(instrs), "loops": loops(instrs)}
        f = result[name]["function"]
        print(f"{name}: " + ", ".join(f"{k} {f[k]}" for k in (*CLASSES, "total")))
        for lp in [lp for lp in result[name]["loops"] if lp["total"] > 40][:4]:  # step loops
            print(f"  loop {lp['from']}-{lp['to']}: "
                  + ", ".join(f"{k} {lp[k]}" for k in (*CLASSES, "total")) + f", {lp['mufu_ops']}")
    pathlib.Path(args.out).write_text(json.dumps({"library": str(lib), "kernels": result},
                                                 indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
