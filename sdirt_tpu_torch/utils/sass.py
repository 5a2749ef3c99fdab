"""Instruction counts from the SASS of a built kernel (cuobjdump -sass).

``ncu`` does not run on the card's machine, so where a kernel's time goes
is read from the machine code: ``parse`` splits a cuobjdump listing into
functions, ``static_counts`` counts a function's instructions by opcode, and
``fast_path`` counts the instructions one thread executes through a
straight-line function when every slow path is skipped (the IEEE divide
and square-root fallbacks that nvcc places behind a branch and a CALL).
chip_smoke.py applies them to K1 (csrc/fused_trace.cu) per ray.
"""

from __future__ import annotations

import collections
import re
import subprocess

_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_FUNC = re.compile(r"Function : (\S+)")
# opcode groups reported by summary()
GROUPS = (("FP32", ("FADD", "FMUL", "FFMA")), ("MUFU", ("MUFU",)),
          ("compare/select", ("FSETP", "FSEL", "FMNMX", "ISETP", "SEL", "PLOP3")),
          ("branch", ("BRA", "BSSY", "BSYNC", "CALL", "RET")),
          ("load/store", ("LDS", "LDC", "ULDC", "LDG", "STG", "STS")))


def cuobjdump(path: str, timeout: float = 60.0) -> str:
    """The SASS listing of a shared library or cubin."""
    from .kernels import nvcc
    tool = nvcc()[:-len("nvcc")] + "cuobjdump"
    return subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          timeout=timeout, check=True).stdout


def parse(listing: str) -> dict[str, list[tuple[int, str, str, str]]]:
    """{function: [(address, predicate, opcode, operands), ...]}."""
    funcs, cur = {}, None
    for line in listing.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INS.search(line) if cur is not None else None
        if m:
            cur.append((int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3),
                        m.group(4).strip()))
    return funcs


def _base(op: str) -> str:
    return op.split(".")[0]


def static_counts(ins) -> collections.Counter:
    """Every instruction of a function, by base opcode, and 'total'."""
    cnt = collections.Counter(_base(op) for _, _, op, _ in ins)
    cnt["total"] = len(ins)
    return cnt


def fast_path(ins) -> collections.Counter:
    """The instructions of one pass from the entry to the first EXIT, by
    base opcode: an unconditional branch is taken; a conditional one is
    taken when the block it would fall into reaches a CALL first (a slow
    path), else not. Meant for straight-line code; loops are not walked."""
    at = {addr: k for k, (addr, *_rest) in enumerate(ins)}
    cnt = collections.Counter()
    k = 0
    while k < len(ins) and cnt["total"] < len(ins):
        _, pred, op, args = ins[k]
        base = _base(op)
        cnt[base] += 1
        cnt["total"] += 1
        if base == "EXIT" and not pred:
            break
        if base == "BRA":
            target = at[int(re.search(r"0x([0-9a-f]+)", args).group(1), 16)]
            if not pred or _reaches_call(ins, k + 1):
                k = target
                continue
        k += 1
    return cnt


def _reaches_call(ins, k: int) -> bool:
    for _, _, op, _ in ins[k:]:
        base = _base(op)
        if base == "CALL":
            return True
        if base in ("BRA", "EXIT", "BSYNC"):
            return False
    return False


def summary(cnt) -> str:
    parts = [f"{cnt['total']} instructions"]
    for name, ops in GROUPS:
        parts.append(f"{name} {sum(cnt[o] for o in ops)}")
    parts.append(f"(FADD {cnt['FADD']}, FMUL {cnt['FMUL']}, FFMA {cnt['FFMA']}; "
                 f"CALL {cnt['CALL']})")
    return ", ".join(parts)
