"""A static reading of the SASS of the built kernels: their loops, the
instructions of one iteration, the branches to the slow paths of divide,
reciprocal, ``sinf``/``cosf`` and ``sqrtf``, and the dependent chain.

    text = disassemble('safe_control_gym_tpu_torch/csrc/build/libquad_kernels.so')
    for name, code in parse(text).items():
        for loop in loops(code):
            print(name, loop.summary())

``cuobjdump -sass`` prints each kernel as a list of instructions. A loop is
the code between a backward branch and its target. Inside a loop, a forward
conditional branch that skips a call, a local-memory access or a loop of its
own skips a slow path (the divide's and reciprocal's ``CALL`` to their
fix-up routine, ``sqrtf``'s likewise, the Payne-Hanek reduction that
``sinf`` and ``cosf`` take for arguments beyond about 1e5); the rest is the
fast path, which an iteration runs when no operand is special.

The dependent chain is counted on the fast path with a latency table of
Hopper's pipes: ``LATENCY`` holds estimates of fixed pipe latencies, not
measurements; ``loops(code, table)`` takes another table, such as one whose
classes ``csrc/latency_probe.cu`` measured on the card
(``chain.calibrated_latency``). ``critical`` is the longest dependent path of
one iteration; ``recurrence`` the growth of that path from two iterations
to three laid end to end, the cycles an iteration adds to the chain that
runs through the loop's registers, however the compiler moves a value
between registers. No schedule runs an iteration in fewer cycles than its
recurrence, whatever its issue rate.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from dataclasses import dataclass, field

__all__ = ['Instr', 'Loop', 'LATENCY', 'op_class', 'latency', 'disassemble', 'parse', 'loops',
           'ptxas_resources']

# Cycles from issue until a dependent instruction may issue (estimates).
LATENCY = {
    'alu': 4,        # FADD FMUL FFMA FMNMX FSEL FSETP IADD3 LOP3 SHF SEL ISETP MOV IMAD ...
    'mufu': 18,      # MUFU.RCP .RSQ .SIN .EX2 .LG2
    'convert': 14,   # F2I I2F F2F FRND
    'fp64': 8,       # DADD DMUL DFMA DSETP
    'shfl': 24,
    'shared': 30,    # LDS
    'local': 30,     # LDL (an L1 hit)
    'global': 250,   # LDG
    'constant': 8,   # LDC
    'check': 8,      # FCHK
    'bits': 10,      # POPC FLO BREV
    'control': 0,    # BRA CALL RET EXIT BSSY BSYNC ...
}
_CONTROL = {'BRA', 'BRX', 'CALL', 'RET', 'EXIT', 'BSSY', 'BSYNC', 'WARPSYNC', 'NOP', 'BAR',
            'JMP', 'JMX', 'BPT', 'YIELD', 'KILL', 'DEPBAR', 'MEMBAR', 'ERRBAR', 'CCTL',
            'NANOSLEEP', 'PMTRIG', 'ACQBULK', 'SYNCS', 'ELECT', 'ENDCOLLECTIVE'}
_STORES = {'ST', 'STG', 'STS', 'STL', 'RED', 'REDG', 'STSM'}
_PRED_ONLY = {'ISETP', 'FSETP', 'DSETP', 'HSETP2', 'FCHK', 'PLOP3', 'PSETP', 'UISETP',
              'UPLOP3', 'VOTEU'}
_REG = re.compile(r'(?<![\w.])(!?)(U?R\d+|U?P\d|URZ|RZ|UPT|PT)((?:\.\w+)*)')


def op_class(op: str) -> str:
    """The LATENCY class of an opcode (its name with modifiers)."""
    base = op.split('.')[0]
    if base in _CONTROL or base in _STORES:
        return 'control'
    if base == 'MUFU':
        return 'mufu'
    if base in ('F2I', 'I2F', 'F2F', 'FRND'):
        return 'convert'
    if base in ('DADD', 'DMUL', 'DFMA', 'DSETP', 'DMNMX'):
        return 'fp64'
    if base == 'SHFL':
        return 'shfl'
    if base in ('LDS', 'LDSM'):
        return 'shared'
    if base == 'LDL':
        return 'local'
    if base in ('LDG', 'LD', 'ATOM', 'ATOMG', 'LDGSTS'):
        return 'global'
    if base in ('LDC', 'ULDC', 'S2R', 'S2UR', 'CS2R'):
        return 'constant'
    if base == 'FCHK':
        return 'check'
    if base in ('POPC', 'FLO', 'BREV'):
        return 'bits'
    return 'alu'


def latency(op: str, table=None) -> int:
    """The latency of an opcode in ``table`` (default LATENCY)."""
    return (table or LATENCY)[op_class(op)]


@dataclass
class Instr:
    addr: int
    guard: str | None        # the guard predicate ('P0', '!P0') or None
    op: str                  # opcode with modifiers, e.g. 'FSETP.GE.AND'
    operands: list
    target: int | None = None
    dests: list = field(default_factory=list)
    srcs: list = field(default_factory=list)

    @property
    def base(self) -> str:
        return self.op.split('.')[0]

    @property
    def text(self) -> str:
        guard = f'@{self.guard} ' if self.guard else ''
        return f'{guard}{self.op} {", ".join(self.operands)}'


def disassemble(lib_path: str) -> str:
    """``cuobjdump -sass`` of a built shared library."""
    tool = shutil.which('cuobjdump')
    if tool is None:
        from torch.utils.cpp_extension import CUDA_HOME
        tool = os.path.join(CUDA_HOME or '/usr/local/cuda', 'bin', 'cuobjdump')
    return subprocess.run([tool, '-sass', lib_path], capture_output=True, text=True,
                          check=True).stdout


def _registers(operand: str):
    """(name, negated) of every register or predicate an operand names; a
    64-bit operand (``R2.64``) names its pair."""
    out = []
    for neg, name, mods in _REG.findall(operand):
        if name in ('RZ', 'URZ', 'PT', 'UPT'):
            continue
        out.append((name, bool(neg)))
        if '.64' in mods:
            prefix = 'UR' if name.startswith('UR') else 'R'
            out.append((f'{prefix}{int(name[len(prefix):]) + 1}', False))
    return out


def _is_pred(operand: str) -> bool:
    return re.fullmatch(r'!?U?P(\d|T)', operand.strip()) is not None


def _dataflow(ins: Instr) -> None:
    """Fill ``dests`` and ``srcs``: the leading predicate operands are
    written; then, unless the opcode writes predicates only, the first
    register and the predicates right after it (carries); stores and control
    write nothing. A guarded write also reads the old value."""
    ops = ins.operands
    i = 0
    dests = []
    if ins.base not in _CONTROL and ins.base not in _STORES:
        while i < len(ops) and _is_pred(ops[i]):
            dests += [r for r, _ in _registers(ops[i])]
            i += 1
        if ins.base not in _PRED_ONLY and i < len(ops) and _registers(ops[i]):
            regs = [r for r, _ in _registers(ops[i])]
            wide = ('.WIDE' in ins.op or ins.base.startswith('D')
                    or ins.op.startswith(('F2F.F64', 'I2F.F64', 'MOV.64')))
            if wide and len(regs) == 1 and regs[0].startswith('R'):
                regs.append(f'R{int(regs[0][1:]) + 1}')
            dests += regs
            i += 1
            while i < len(ops) and _is_pred(ops[i]):
                dests += [r for r, _ in _registers(ops[i])]
                i += 1
    srcs = [r for op in ops[i:] for r, _ in _registers(op)]
    if ins.guard:
        srcs += [r for r, _ in _registers(ins.guard)]
        srcs += dests
    ins.dests, ins.srcs = dests, srcs


_LINE = re.compile(r'/\*([0-9a-fA-F]{4,})\*/\s+(.*?)\s*;')
_FUNC = re.compile(r'Function\s*:\s*(\S+)')
_LABEL = re.compile(r'^\s*(\.L_x_\d+)\s*:')


def parse(text: str) -> dict:
    """{function name: [Instr]} of a ``cuobjdump -sass`` (or ``nvdisasm``)
    listing. Branch targets are resolved to instruction addresses."""
    funcs, code, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            code = funcs.setdefault(m.group(1), [])
            labels, pending = {}, []
            continue
        m = _LABEL.match(line)
        if m and code is not None:
            pending.append(m.group(1))
            continue
        m = _LINE.search(line)
        if not m or code is None:
            continue
        addr, body = int(m.group(1), 16), m.group(2).strip()
        for label in pending:
            labels[label] = addr
        pending = []
        guard = None
        if body.startswith('@'):
            guard, body = body[1:].split(None, 1)
        parts = body.split(None, 1)
        op = parts[0]
        operands = [o.strip() for o in parts[1].split(',')] if len(parts) > 1 else []
        ins = Instr(addr, guard, op, operands)
        _dataflow(ins)
        ins._labels = labels            # resolved after the function is read
        code.append(ins)
    for code in funcs.values():
        for ins in code:
            if ins.base in ('BRA', 'CALL', 'BSSY', 'JMP', 'BRX') and ins.operands:
                ref = ins.operands[-1].strip('`() ')
                if ref in ins._labels:
                    ins.target = ins._labels[ref]
                else:
                    m = re.search(r'0x([0-9a-fA-F]+)', ins.operands[-1])
                    if m:
                        ins.target = int(m.group(1), 16)
            del ins._labels
    return funcs


@dataclass
class Loop:
    start: int                 # address of the loop head
    end: int                   # address of the backward branch
    instructions: int          # every instruction between them
    fast_path: int             # those outside slow-path regions
    slow_paths: dict           # {kind: branch sites} on the fast path
    mufu: int
    shuffles: int
    converts: int              # F2I on the fast path (sin/cos reductions)
    recurrence: float          # cycles an iteration adds to the loop-carried chain
    critical: float            # cycles, the longest path of one iteration
    contains_sincos: bool

    def summary(self) -> dict:
        return dict(start=hex(self.start), end=hex(self.end), instructions=self.instructions,
                    fast_path=self.fast_path, slow_paths=self.slow_paths, mufu=self.mufu,
                    shuffles=self.shuffles, converts=self.converts,
                    recurrence_cycles=self.recurrence, critical_cycles=self.critical)


def _kind_of(ins) -> str | None:
    if ins.op.startswith('FCHK'):
        return 'div'
    if ins.op.startswith('MUFU.RSQ'):
        return 'sqrt'
    if ins.op.startswith('MUFU.RCP'):
        return 'rcp'
    if ins.base == 'FSETP' and any(o.startswith('|') for o in ins.operands):
        consts = [float(o) for o in ins.operands
                  if re.fullmatch(r'-?\d+(\.\d*)?(e[-+]?\d+)?', o)]
        if any(abs(c) >= 1000.0 for c in consts):
            return 'sincos'
    return None


def _slow_kind(code, i, j) -> str:
    """What the slow-path branch at index i (skipping to index j) guards,
    from the instruction that wrote its guard predicate: the divide's FCHK,
    the range check of ``sinf`` (``|x| >= 105615``), or an integer range test
    of a reciprocal or square root, told apart by the MUFU next to it."""
    pred = code[i].guard.lstrip('!')
    writer = next((b for b in reversed(code[max(0, i - 40):i]) if pred in b.dests), None)
    if writer is None:
        return 'other'
    kind = _kind_of(writer)
    if kind in ('div', 'sincos'):
        return kind
    if writer.base == 'ISETP':
        for b in code[max(0, i - 8):i] + code[j:j + 6]:
            kind = _kind_of(b)
            if kind in ('sqrt', 'rcp'):
                return kind
    return 'other'


def _slow_regions(code, lo, hi):
    """[(first, last, kind)] index ranges inside code[lo:hi] that a forward
    conditional branch skips and that hold a call, a local-memory access or a
    backward branch: the slow paths."""
    regions = []
    index = {ins.addr: k for k, ins in enumerate(code)}
    for i in range(lo, hi):
        ins = code[i]
        # BRA.DIV leaves for the out-of-line copy that a diverged warp runs.
        if ins.base != 'BRA' or ins.guard is None or ins.target is None or '.DIV' in ins.op:
            continue
        if ins.target <= ins.addr or ins.target not in index or index[ins.target] > hi:
            continue
        j = index[ins.target]
        body = code[i + 1:j]
        if any(b.base in ('CALL', 'LDL', 'STL') or (b.base == 'BRA' and b.target is not None
                                                    and b.target <= b.addr)
               for b in body):
            regions.append((i + 1, j - 1, _slow_kind(code, i, j)))
    return regions


def _longest(path, table=None) -> float:
    """Longest dependent path over ``path`` (program order), from the
    registers' values at its top."""
    ready = {}        # register -> cycle its current value is ready
    best = 0
    for ins in path:
        t = max((ready.get(src, 0) for src in ins.srcs), default=0) + latency(ins.op, table)
        for d in ins.dests:
            ready[d] = t
        best = max(best, t)
    return best


def loops(code, table=None) -> list:
    """Every loop of a function (code between a backward branch and its
    target), innermost last among loops that share a head; chains counted
    with ``table`` (default LATENCY)."""
    index = {ins.addr: k for k, ins in enumerate(code)}
    out = []
    for i, ins in enumerate(code):
        if ins.base != 'BRA' or ins.target is None or ins.target > ins.addr:
            continue
        if ins.target not in index:
            continue
        lo, hi = index[ins.target], i + 1
        regions = _slow_regions(code, lo, hi)
        slow = set()
        kinds = {}
        for a, b, kind in regions:
            # A region inside another (the infinity test inside sinf's slow
            # path) is part of that one's slow path.
            if not any(a2 <= a and b <= b2 and (a2, b2) != (a, b) for a2, b2, _ in regions):
                kinds[kind] = kinds.get(kind, 0) + 1
            slow.update(range(a, b + 1))
        path = [code[k] for k in range(lo, hi) if k not in slow]
        critical = _longest(path, table)
        out.append(Loop(
            start=code[lo].addr, end=ins.addr, instructions=hi - lo,
            fast_path=len(path), slow_paths=kinds,
            mufu=sum(p.base == 'MUFU' for p in path),
            shuffles=sum(p.base == 'SHFL' for p in path),
            converts=sum(p.base == 'F2I' for p in path),
            recurrence=_longest(path * 3, table) - _longest(path * 2, table),
            critical=critical,
            contains_sincos=kinds.get('sincos', 0) > 0))
    return out


def ptxas_resources(text: str) -> dict:
    """{kernel: {registers, stack, spill_stores, spill_loads}} of every entry
    function in ``nvcc -Xptxas -v``'s report (``ops/_build.py`` ``ptxas_log``),
    bytes for the last three."""
    out, entry, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {}
            continue
        m = re.search(r'Function properties for (\S+)', line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and props in out:
            out[props].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
            continue
        m = re.search(r'Used (\d+) registers', line)
        if m and entry is not None:
            out[entry]['registers'] = int(m.group(1))
    return out
