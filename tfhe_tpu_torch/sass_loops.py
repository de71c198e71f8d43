"""Data instructions per loop body, by pipe, in the SASS of a kernel library.

    python -m tfhe_tpu_torch.sass_loops tfhe_tpu_torch/_build/lib<name>.sass [pattern]

prints, for every kernel whose mangled name contains ``pattern``, each loop
(a backward branch and its target) with the instructions of its body that
lie in no nested loop: their count, the loads and stores from shared and
global memory, and the data instructions on each INT32 pipe. The build
(``_build.build_cuda``) leaves the SASS beside each library.

A data instruction reads a value loaded from memory (shared or global) or
computed from one: a forward taint pass over the function in address order,
repeated so that loop-carried values settle, where a load taints its
destination and any other instruction taints its destinations when one of
its sources (registers or a guard predicate) is tainted, and clears them
otherwise (a constant load clears them). Index arithmetic, loads, stores,
branches and barriers are left out. IMAD in all its forms runs on the FMA pipe; every other integer
instruction (IADD3, ISETP, SEL, LOP3, SHF, LEA, VIADD, ...) on the ALU
pipe, but the tensor-core instructions (``TENSOR``: IMMA, HMMA, HGMMA,
IGMMA), which each loop counts apart as ``tensor``, data or not, and
lists in ``tensor_ops`` when they write a register (a ``wgmma``
commit compiles to an HGMMA into RZ, which issues no product).
IMAD.HI and IMAD.WIDE take more than one issue slot of the FMA pipe
(``FMA_DOUBLE``): on an H100 a stream of them issues at 0.43-0.47 of
IMAD's rate, 2.2-2.3 slots each (``tools.vpu_primitives``' ``mul_hi`` and
``mul_wide`` rows), but beside plain IMADs (``shoup``) at most 1.93. Each
counts ``DOUBLE_SLOTS`` = 1.5 slots: not a measured cost but a floor chosen
so that a bound stays below every time measured. Each loop gives
``fma_slots``, and ``flex``: the ALU instructions that may issue on the FMA
pipe instead (VIADD). The per-unit counts of
``ops/kernel_bench.py::SASS_OPS`` are read from this output (an unrolled
body divided by its copies), their FMA column in issue slots, their third
column the flex instructions.
"""

from __future__ import annotations

import re
import sys

_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)"
                  r"\s*(.*?)\s*;")
_REG = re.compile(r"\b(U?R\d+|U?P\d+)\b")
_LOADS = ("LDS", "LDG", "LD", "LDSM")
#: no register result: stores, branches, barriers
_SKIP = ("STS", "STG", "ST", "ATOMS", "RED", "BRA", "BSSY", "BSYNC", "BAR",
         "EXIT", "NOP", "WARPSYNC", "CALL", "RET", "DEPBAR")
#: results that are not integer-pipe work: constants, special registers
_NO_PIPE = ("LDC", "ULDC", "S2R", "S2UR", "CS2R")
#: FMA-pipe instructions that take more than one of its issue slots, and
#: the slots each counts (a floor that fits the probes, see above)
FMA_DOUBLE = ("IMAD.HI", "IMAD.WIDE")
DOUBLE_SLOTS = 1.5
#: ALU-pipe instructions that also issue elsewhere (``flex``: an H100 ran
#: ``add_mod``'s VIADD, ISETP and SEL at 81.7 per SM and clock, more than
#: one 64-lane pipe)
FLEX = ("VIADD",)
#: tensor-core instructions: on neither INT32 pipe
TENSOR = ("IMMA", "HMMA", "HGMMA", "IGMMA")


def parse(text: str) -> dict:
    """{mangled kernel name: [(address, guard, opcode, operands)]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INS.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), (m.group(2) or "").strip(),
                        m.group(3), m.group(4)))
    return funcs


def _operands(op: str, rest: str):
    """(destinations, sources) of one instruction: the first operand, the
    register after it for a wide result (``.WIDE``, ``.64``), and the
    predicates that follow a register destination (carry outs)."""
    tokens = [t.strip() for t in rest.split(",")]
    regs = [_REG.findall(t) for t in tokens]
    if not regs or not regs[0]:
        return [], [r for rs in regs for r in rs]
    dsts, k = [regs[0][0]], 1
    if re.search(r"\.(WIDE|64)\b", op) and dsts[0].startswith("R"):
        dsts.append(f"R{int(dsts[0][1:]) + 1}")
    while (dsts[0].startswith("R") and k < len(tokens)
           and re.fullmatch(r"!?U?P\d+|PT", tokens[k])):
        dsts += regs[k]
        k += 1
    return dsts, [r for rs in regs[k:] for r in rs]


def data_instructions(ins: list) -> dict:
    """{address: True when the instruction is a data instruction}."""
    tainted, data = set(), {}
    for _ in range(4):
        for addr, guard, op, rest in ins:
            base = op.split(".")[0]
            dsts, srcs = _operands(op, rest)
            if guard:
                srcs = srcs + [guard.lstrip("@!")]
            data[addr] = False
            if base in _LOADS:
                tainted.update(d for d in dsts if not d.startswith("U"))
            elif base not in _SKIP:
                if any(r in tainted for r in srcs):
                    data[addr] = base not in _NO_PIPE
                    tainted.update(dsts)
                elif not guard:
                    tainted.difference_update(dsts)
    return data


def loops(ins: list) -> list:
    """Per loop (target, branch address): the counts of its own body."""
    data = data_instructions(ins)
    spans = sorted({(int(m.group(1), 16), a) for a, _, op, rest in ins
                    if op == "BRA"
                    for m in [re.match(r"(0x[0-9a-f]+)", rest)]
                    if m and int(m.group(1), 16) < a})
    out = []
    for lo, hi in spans:
        nested = [s for s in spans if s != (lo, hi) and lo <= s[0]
                  and s[1] <= hi]
        body = [x for x in ins if lo <= x[0] <= hi
                and not any(a <= x[0] <= b for a, b in nested)]
        count = lambda pre: sum(1 for x in body if x[2].startswith(pre))
        tensor = sum(1 for x in body if x[2].startswith(TENSOR))
        fma = sum(1 for x in body if data[x[0]] and x[2].startswith("IMAD"))
        alu = sum(1 for x in body if data[x[0]]
                  and not x[2].startswith(TENSOR)) - fma
        double = sum(1 for x in body
                     if data[x[0]] and x[2].startswith(FMA_DOUBLE))
        flex = sum(1 for x in body if data[x[0]] and x[2].startswith(FLEX))
        out.append({"loop": f"{lo:#x}-{hi:#x}", "nested": len(nested),
                    "instructions": len(body), "alu": alu, "fma": fma,
                    "fma_slots": fma + (DOUBLE_SLOTS - 1) * double,
                    "flex": flex, "tensor": tensor,
                    "tensor_ops": [x[2] for x in body
                                   if x[2].startswith(TENSOR)
                                   and not x[3].startswith("RZ")],
                    "lds": count("LDS"), "sts": count("STS"),
                    "ldg": count("LDG")})
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        funcs = parse(f.read())
    pattern = argv[1] if len(argv) > 1 else ""
    for name, ins in funcs.items():
        if pattern not in name:
            continue
        print(f"{name}: {len(ins)} instructions")
        for r in loops(ins):
            if r["alu"] or r["fma"] or r["tensor"]:
                print("  loop {loop} (nested {nested}): {instructions} "
                      "instructions, ALU {alu}, FMA {fma} ({fma_slots} "
                      "slots), tensor {tensor}, LDS {lds}, STS {sts}, "
                      "LDG {ldg}".format(**r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
