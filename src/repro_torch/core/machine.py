"""FEATHER+ functional machine: MINISA instruction *semantics* in PyTorch.

This module plays the role the cycle-accurate RTL plays in the paper:
it implements the semantics of every MINISA instruction so that a
(mapper-produced) Program can be validated end-to-end against the plain
einsum oracle.  Timing lives in ``core/perf.py``; this file is purely
functional.  It is the port's own reference trajectory: it launches no
hand-written kernel, only PyTorch operations on its ``device``.

The orchestration loop (walking a Program's TraceOp stream) lives in
``repro_torch.backends.interpreter.InterpreterBackend``: the machine
exposes ``step``/``flush`` and the backend drives them.  The module-level
``run_trace`` / ``run_program`` helpers are thin wrappers over that
backend.

Architecture state (torch tensors on ``device``):

  streaming buffer   D_str x AW image      (single bank, FEATHER+ §III-B)
  stationary buffer  D_sta x AW image      (feeds PE local registers)
  output buffer      dense accumulator over the full (streamed m,
                     stationary c) extent; tiles drain slices of it
  layout registers   one VNLayout per operand (re-bound by each Load)
  theta_EM register  last ExecuteMapping (ExecuteStreaming reuses r0/G_r/G_c)

Execution is genuinely tiled: Loads place operand *slices* (under the
mapper's buffer-capacity bounds) and the Execute lattice addresses whatever
is resident, with the TraceOp side-band carrying each tile's global
offsets/bounds.  Consecutive ExecuteStreaming invocations that share every
static parameter (shapes, strides, layouts, buffer contents) are batched:
their gathers and products run as tensors over the whole batch (in
chunks that bound memory), so large GEMMs do not pay a per-invocation
dispatch.  The scatter-add that reduces them (BIRRD + the output buffer)
is ``index_put_(accumulate=True)``, which sums in the same order on every
run; ``index_add_`` on CUDA would not (atomics).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.feather import FeatherConfig
from repro_torch.core import isa, mapping, vn
from repro_torch.core.layout import VNLayout
from repro_torch.core.program import Program, TraceOp  # noqa: F401 (re-export)

# dyn row of one invocation: [r0, c0, m0, j_off, m_off, c_off, r_hi, c_hi,
# m_hi]
_DYN_WIDTH = 9

#: elements of the largest gathered operand one chunk of a batch holds
_CHUNK_ELEMS = 1 << 22


def _invoke_batch(sta_buf, str_buf, o_acc, sta_first_rows, sta_cols,
                  str_first_rows, str_cols, dyn, *, ah, aw, t_steps,
                  vn_size, g_r, g_c, s_r, s_c, s_m, sta_red, sta_free,
                  str_red, str_free) -> None:
    """A batch of same-shaped (E.Mapping, E.Streaming) pairs: gather ->
    dot -> scatter-add into ``o_acc`` (in place), invocation by
    invocation in the order of ``dyn`` [N, 9].

    The three-level reduction (temporal-in-PE, spatial-BIRRD, temporal-OB)
    collapses to a masked scatter-add, which is its functional meaning.
    Address tables are precomputed host-side from the VNLayouts (pure index
    math), so the body is static-shape gathers + one einsum + a
    scatter-add over the batch.
    """
    dev = o_acc.device
    (r0, c0, m0, j_off, m_off, c_off, r_hi, c_hi, m_hi) = (
        dyn[:, i] for i in range(_DYN_WIDTH))
    a_h = torch.arange(ah, device=dev)
    e = torch.arange(vn_size, device=dev)
    n = dyn.shape[0]

    # Eq. 1's lattices at the origin (core.mapping), moved by each
    # invocation's (r0, c0, m0)
    lat = mapping.tile_indices(
        isa.ExecuteMapping(g_r=g_r, g_c=g_c, s_r=s_r, s_c=s_c),
        isa.ExecuteStreaming(s_m=s_m, t=t_steps, vn_size=vn_size), ah, aw)
    r = r0[:, None] + torch.as_tensor(lat.r, device=dev)          # [N, AW]
    c = c0[:, None, None] + torch.as_tensor(lat.c, device=dev)    # [N, AH, AW]
    m = m0[:, None, None] + torch.as_tensor(lat.m, device=dev)    # [N, T, AW]
    j = r + j_off[:, None]                                        # [N, AW]

    # "FEATHER+ activates only VN_size x AW PEs" (paper §VI-D): rows beyond
    # vn_size are skipped -- without this mask, c-index aliasing across PE
    # rows would double-count products whenever vn_size < AH.  The _hi
    # bounds are the current tile's extents: group-lattice overhang beyond
    # them is the paper's implicit zero padding.
    row_active = a_h < vn_size                                    # [AH]
    r_in = (r >= 0) & (r < r_hi[:, None])                         # [N, AW]
    valid_s = (row_active[None, :, None] & r_in[:, None, :]
               & (c >= 0) & (c < c_hi[:, None, None]))            # [N, AH, AW]
    valid_m = (m >= 0) & (m < m_hi[:, None, None])                # [N, T, AW]
    j_valid = (j >= 0) & (j < (r_hi + j_off)[:, None])            # [N, AW]

    rs = r.clamp(0, sta_red - 1)[:, None, :].expand(n, ah, aw)
    cs = c.clamp(0, sta_free - 1)
    ms = m.clamp(0, str_free - 1)
    js = j.clamp(0, str_red - 1)[:, None, :].expand(n, t_steps, aw)

    # stationary VN elements: [N, AH, AW, vn]
    s_vals = sta_buf[sta_first_rows[rs, cs][..., None] + e,
                     sta_cols[rs, cs][..., None]]
    s_vals = torch.where(valid_s[..., None], s_vals, 0.0)
    # streaming VN elements: [N, T, AW, vn]
    t_vals = str_buf[str_first_rows[js, ms][..., None] + e,
                     str_cols[js, ms][..., None]]
    t_vals = torch.where((valid_m & j_valid[:, None, :])[..., None],
                         t_vals, 0.0)

    # psum[n, t, h, w] = dot over vn  (temporal reduction inside the PE)
    psums = torch.einsum("ntwv,nhwv->nthw", t_vals, s_vals)

    # BIRRD + OB reduction == scatter-add into the global (m, c) cell
    n_free = o_acc.shape[1]
    mg = m + m_off[:, None, None]
    cg = c + c_off[:, None, None]
    flat = mg[:, :, None, :] * n_free + cg[:, None, :, :]    # [N, T, AH, AW]
    mask = valid_m[:, :, None, :] & valid_s[:, None, :, :]
    psums = torch.where(mask, psums, 0.0)
    flat = torch.where(mask, flat, 0)
    o_acc.view(-1).index_put_((flat.reshape(-1),), psums.reshape(-1),
                              accumulate=True)


def _address_tables(lay: VNLayout, red: int, free: int, device):
    r_idx, c_idx = np.meshgrid(np.arange(red), np.arange(free), indexing="ij")
    first_row, col = lay.address(r_idx, c_idx)
    return (torch.as_tensor(first_row, dtype=torch.long, device=device),
            torch.as_tensor(col, dtype=torch.long, device=device))


def _to_vns(src: torch.Tensor, operand: str, size: int) -> torch.Tensor:
    """Device twin of ``vn.to_weight_vns`` / ``to_input_vns``: VN-ify the
    reduction rank with zero padding, without leaving the device."""
    if operand == "W":                      # [K, N] -> [rows, N, vn]
        k, n = src.shape
        rows = vn.num_vns(k, size)
        sp = F.pad(src, (0, 0, 0, rows * size - k))
        return sp.reshape(rows, size, n).permute(0, 2, 1)
    m, k = src.shape                        # [M, K] -> [rows, M, vn]
    rows = vn.num_vns(k, size)
    sp = F.pad(src, (0, rows * size - k))
    return sp.reshape(m, rows, size).permute(1, 0, 2)


class FeatherMachine:
    """MINISA architecture state + per-instruction semantics.

    Drive it with ``step(op, tensors)`` per TraceOp and a final ``flush()``
    (or use ``backends.InterpreterBackend``, which owns that loop).  Its
    state and outputs are tensors on ``device`` (``"cuda"`` by default);
    inputs may be tensors or numpy arrays."""

    def __init__(self, cfg: FeatherConfig, *, device="cuda",
                 max_depth: int | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FeatherMachine(device='cuda') needs a CUDA "
                               "device; pass device='cpu' to run on the CPU")
        # Simulated buffer depth: tests run tiny workloads; materialising the
        # full multi-hundred-K-row buffer would be wasteful.  The semantics
        # are unchanged (the mapper's capacity feasibility check still uses
        # the real depths).
        self.max_depth = max_depth
        self.reset()

    def reset(self):
        # operand buffers live on the device: Loads scatter host slices in,
        # on-chip commits place straight from the device accumulator, so a
        # chained segment never round-trips through the host between layers
        self._bufs: dict[str, torch.Tensor | None] = {"stationary": None,
                                                      "streaming": None}
        self._buf_ver = {"stationary": 0, "streaming": 0}
        self.layouts: dict[str, VNLayout] = {}
        self.layout_extents: dict[str, tuple[int, int]] = {}
        self.o_acc: torch.Tensor | None = None
        self.o_extents: tuple[int, int] | None = None
        self._assembled: torch.Tensor | None = None   # drained tiles
        self.em: isa.ExecuteMapping | None = None
        self.df = isa.Dataflow.WOS
        self.outputs: dict[str, torch.Tensor] = {}
        self._addr_cache: dict[tuple, tuple] = {}
        self._pending: list[list[int]] = []
        self._pending_key: tuple | None = None
        self._pending_activation = None

    # -- helpers -------------------------------------------------------------
    def _depth(self, needed: int) -> int:
        if self.max_depth is None:
            return max(needed, 1)
        return max(self.max_depth, needed)

    def _role(self, target: isa.BufferTarget) -> str:
        return ("stationary" if target == isa.BufferTarget.STATIONARY
                else "streaming")

    def _tensor(self, src) -> torch.Tensor:
        if isinstance(src, torch.Tensor):
            return src.to(device=self.device, dtype=torch.float32)
        return torch.from_numpy(np.ascontiguousarray(
            src, dtype=np.float32)).to(self.device)

    def _tables(self, lay: VNLayout, red: int, free: int) -> tuple:
        key = (lay, red, free)
        hit = self._addr_cache.get(key)
        if hit is None:
            hit = _address_tables(lay, red, free, self.device)
            self._addr_cache[key] = hit
        return hit

    # -- instruction semantics -----------------------------------------------
    def step(self, op: TraceOp, tensors):
        inst = op.inst
        if isinstance(inst, isa.ExecuteMapping):
            self.em = inst
            return
        if isinstance(inst, isa.ExecuteStreaming):
            self._enqueue(inst, op.meta)
            return
        self.flush()
        if isinstance(inst, (isa.SetWVNLayout, isa.SetIVNLayout)):
            operand = "W" if isinstance(inst, isa.SetWVNLayout) else "I"
            self.layouts[operand] = op.meta["layout"]
        elif isinstance(inst, isa.SetOVNLayout):
            m_ext = op.meta["m_extent"]
            n_ext = op.meta["n_extent"]
            self.o_acc = torch.zeros((m_ext, n_ext), dtype=torch.float32,
                                     device=self.device)
            self.o_extents = (m_ext, n_ext)
            self._assembled = torch.zeros_like(self.o_acc)
            self.layouts["O"] = op.meta.get("layout")
        elif isinstance(inst, isa.Load):
            self._load(op, tensors)
        elif isinstance(inst, isa.Activation):
            self._pending_activation = (op.meta.get("fn"),
                                        op.meta.get("name"))
        elif isinstance(inst, isa.Write):
            self._write(op)
        else:
            raise NotImplementedError(type(inst))

    # -- VN placement shared by Load and on-chip commit ----------------------
    def _place(self, src, operand: str, lay: VNLayout,
               role: str, *, vn_row0: int = 0, col0: int = 0,
               reset: bool = True) -> tuple[int, int]:
        """VN-ify ``src`` and write it into ``role``'s buffer through
        ``lay`` at the given VN-array offset; returns the placed extents.

        ``src`` may be a host tensor (Load) or a device tensor (on-chip
        commit -- the whole placement stays on the device, so a chained
        segment reuses the accumulator without a host round trip).  The
        stationary tensor is VN-ified along its reduction rank as a
        [K, free] matrix regardless of dataflow; operand kind selects the
        grouping convention.
        """
        vns = _to_vns(self._tensor(src), "W" if operand == "W" else "I",
                      lay.vn_size)
        depth = self._depth(lay.rows_needed)
        buf = self._bufs[role]
        if reset or buf is None or buf.shape != (depth, lay.aw):
            buf = torch.zeros((depth, lay.aw), dtype=torch.float32,
                              device=self.device)
        red, free = vns.shape[0], vns.shape[1]
        r_idx, c_idx = np.meshgrid(np.arange(red), np.arange(free),
                                   indexing="ij")
        first_row, col = lay.address(r_idx + vn_row0, c_idx + col0)
        rows = first_row[..., None] + np.arange(lay.vn_size)
        cols = np.broadcast_to(col[..., None], rows.shape).copy()
        buf.index_put_((torch.as_tensor(rows, device=self.device),
                        torch.as_tensor(cols, device=self.device)), vns)
        self._bufs[role] = buf
        self._buf_ver[role] += 1
        return red, free

    # -- Load: place a host-tensor slice through its layout ------------------
    def _load(self, op: TraceOp, tensors):
        meta = op.meta
        name = meta["tensor"]
        src = tensors.get(name) if tensors else None
        if src is None:
            src = self.outputs.get(name)
        if src is None:
            raise KeyError(f"Load refers to unknown tensor {name!r}")
        sl = meta.get("slice")
        if sl is not None:
            r0, r1, c0, c1 = sl
            src = src[r0:r1, c0:c1]
        operand = meta["operand"]
        lay = meta.get("layout") or self.layouts[operand]
        red, free = self._place(
            src, operand, lay, self._role(op.inst.target),
            vn_row0=meta.get("vn_row0", 0), col0=meta.get("col0", 0),
            reset=meta.get("reset", True))
        self.layouts[operand] = lay
        self.layout_extents[operand] = tuple(
            meta.get("extents", (red, free)))

    # -- Execute: batch same-shaped invocations ------------------------------
    def _enqueue(self, es: isa.ExecuteStreaming, meta: dict):
        if self.em is None:
            raise RuntimeError("ExecuteStreaming before ExecuteMapping")
        if self.o_acc is None:
            raise RuntimeError("ExecuteStreaming before SetOVNLayout")
        self.df = es.df
        em = self.em
        sta_operand = "W" if es.df == isa.Dataflow.WOS else "I"
        str_operand = "I" if es.df == isa.Dataflow.WOS else "W"
        sta_lay = self.layouts[sta_operand]
        str_lay = self.layouts[str_operand]
        sta_red, sta_free = self.layout_extents[sta_operand]
        str_red, str_free = self.layout_extents[str_operand]
        key = (es.t, es.vn_size, es.s_m, es.df, em.g_r, em.g_c, em.s_r,
               em.s_c, sta_lay, sta_red, sta_free, str_lay, str_red,
               str_free, self._buf_ver["stationary"],
               self._buf_ver["streaming"])
        if self._pending and key != self._pending_key:
            self.flush()
        self._pending_key = key
        self._pending.append([
            em.r0, em.c0, es.m0,
            meta.get("j_off", 0), meta.get("m_off", 0),
            meta.get("c_off", 0),
            meta.get("r_hi", sta_red), meta.get("c_hi", sta_free),
            meta.get("m_hi", str_free)])

    def flush(self):
        """Run the pending batch of invocations.  Unlike the JAX machine,
        no power-of-two padding of the batch: that only bounded XLA's
        compile keys, and its sentinel rows added nothing."""
        if not self._pending:
            return
        (t_steps, vn_size, s_m, df, g_r, g_c, s_r, s_c, sta_lay, sta_red,
         sta_free, str_lay, str_red, str_free, _, _) = self._pending_key
        sfr, scol = self._tables(sta_lay, sta_red, sta_free)
        tfr, tcol = self._tables(str_lay, str_red, str_free)
        dyn = torch.as_tensor(np.asarray(self._pending, dtype=np.int64),
                              device=self.device)
        self._pending = []
        self._pending_key = None
        ah, aw = self.cfg.ah, self.cfg.aw
        per = max(t_steps, ah) * aw * max(vn_size, ah)
        chunk = max(1, _CHUNK_ELEMS // per)
        for i in range(0, dyn.shape[0], chunk):
            _invoke_batch(
                self._bufs["stationary"], self._bufs["streaming"],
                self.o_acc, sfr, scol, tfr, tcol, dyn[i:i + chunk],
                ah=ah, aw=aw, t_steps=t_steps, vn_size=vn_size, g_r=g_r,
                g_c=g_c, s_r=s_r, s_c=s_c, s_m=s_m, sta_red=sta_red,
                sta_free=sta_free, str_red=str_red, str_free=str_free)

    # -- Write: drain an output-tile slice, assemble, maybe commit -----------
    def _write(self, op: TraceOp):
        meta = op.meta
        ms, ns = self.o_extents
        m0, m1, n0, n1 = meta.get("slice") or (0, ms, 0, ns)
        block = self.o_acc[m0:m1, n0:n1]        # device slice, no host pull
        if self._pending_activation is not None:
            # applied per drained tile: exact for elementwise activations;
            # row-wise ones (softmax/norms) need full-row tiles (n_n == 1).
            # Registry activations (the runtime's, same numerics as the
            # kernels) run on the device; an unknown callable is the one
            # case that round-trips through the host.
            from repro_torch.runtime.executable import ACTIVATIONS
            fn, name = self._pending_activation
            act = ACTIVATIONS.get(name)
            if act is not None:
                block = act(block)
            else:
                block = self._tensor(np.asarray(fn(block.cpu().numpy())))
            self._pending_activation = None
        self._assembled[m0:m1, n0:n1] = block
        out = self._assembled
        if meta.get("transpose"):
            out = out.T
        self.outputs[meta["tensor"]] = out
        if meta.get("final", True) and meta.get("commit_to") is not None:
            # paper §IV-G: layer i's OB commits on-chip to the next operand
            # buffer (IO-S: stationary, WO-S: streaming); the output becomes
            # layer i+1's input without an off-chip round trip, and layer
            # i+1's SetIVNLayout/Load are elided.  ``out`` is a device
            # tensor, so the commit placement stays on the device end to end.
            lay = meta["layout"]
            red, free = self._place(out, "I", lay, meta["commit_to"])
            self.layouts["I"] = lay
            self.layout_extents["I"] = (red, free)


def run_trace(cfg: FeatherConfig, ops: Iterable[TraceOp], tensors, *,
              device="cuda") -> dict[str, torch.Tensor]:
    from repro_torch.backends.interpreter import InterpreterBackend
    return InterpreterBackend(cfg, device=device).run_trace(ops, tensors)


def run_program(cfg: FeatherConfig, prog: Program, tensors, *,
                device="cuda") -> dict[str, torch.Tensor]:
    from repro_torch.backends.interpreter import InterpreterBackend
    return InterpreterBackend(cfg, device=device).run_program(prog, tensors)
