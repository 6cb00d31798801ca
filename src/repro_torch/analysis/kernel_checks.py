"""Kernel geometry pass: hold every launch to its kernel's contract.

Counterpart of ``repro/analysis/kernel_checks.py``, with its four rule IDs.
The reference proves the tiling of its Pallas call sites against a TPU's
(32, 128) int8 tile and SMEM; the port's kernels are CUDA C++ on Hopper,
called through ``ctypes``, so the same rules hold Hopper's facts instead.
Each launch is a :class:`~repro_torch.kernels.dps_quant.KernelCallGeometry`
built by the builders the wrappers launch through
(``dps_quant.quantize_call_geometry``, ``group_wire_call_geometry``,
``wire_reduce_call_geometry``, ``paged_attn.paged_attn_call_geometry``):
from a layout's Python ints (anywhere, no card needed), or read off a
launch node of a trace recorded on the card (``from_launch``), which adds
the values the call passed.

``KG-PREFETCH-ARITY``
    The launch names an entry of the library's one signature table
    (``_build.KERNEL_SIGNATURES``, from which the loaded entries' ``ctypes``
    ``argtypes`` are bound), and a recorded call passed it as many values
    as the signature has parameters, each one its kind holds: a pointer an
    address or NULL, an ``int`` within 32 bits, a ``long long`` within 64
    (``ctypes`` would truncate an integer past its type's width without a
    word, and the kernel would read another shape); and the grid it passed
    (``nblocks``, ``tiles``) is the grid its geometry builder gives — the
    wrapper and the builder the static checks use agree.

``KG-SMEM-TABLE``
    A grouped kernel's format table has exactly G rows for a G-group
    domain, its tile -> group map one entry a tile; the two together stay
    within ``SMEM_TABLE_BUDGET_BYTES``, and the dynamic shared memory a
    block asks for within the card's opt-in limit
    (``torch.cuda.get_device_properties(...).shared_memory_per_block_optin``;
    an H100's 232,448 bytes off the card).

``KG-TILE-MIN``
    A grouped quantum is a multiple of ``MIN_GROUP_QUANTUM`` (16 int8: one
    16-byte vector, the unit K3 and K4 move and K4's bulk copies take), and
    a block is whole warps.

``KG-TILE-STRADDLE``
    The group-aligned layout keeps every tile inside one group: offsets are
    the cumulative padded sizes, each padded slot is a quantum multiple
    covering its payload, rank chunks are tile-aligned, and ``total =
    n_chunks × chunk`` — the reference's integer arithmetic, unchanged.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.analysis.report import Report
from repro_torch.kernels._build import KERNEL_SIGNATURES
from repro_torch.kernels.dps_quant import (MIN_GROUP_QUANTUM, RED_MAX_SMEM,
                                           SMEM_TABLE_BUDGET_BYTES,
                                           KernelCallGeometry)

WARP = 32

# the parameters that carry a launch's grid (blocks), where an entry has one
_GRID_ARGS = ("nblocks", "tiles")
# the integer range of each ctypes kind of the signature table
_RANGES = {"p": (0, 1 << 64), "i": (-(1 << 31), 1 << 31),
           "l": (-(1 << 63), 1 << 63), "u": (0, 1 << 64)}


def _fits(kind: str, value) -> bool:
    """Does ``value`` pass as the ``ctypes`` kind ``kind`` unchanged?"""
    if kind == "p" and value is None:
        return True
    if kind == "f":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    lo, hi = _RANGES[kind]
    return isinstance(value, int) and lo <= value < hi


def device_smem_budget(device=None) -> int:
    """The dynamic shared memory a block may ask for on ``device`` (a CUDA
    device), or an H100's when ``device`` is None."""
    if device is None:
        return RED_MAX_SMEM
    import torch
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", RED_MAX_SMEM))


def check_call(geom: KernelCallGeometry,
               expected_groups: Optional[int] = None,
               name: str = "kernel-call",
               smem_budget: int = RED_MAX_SMEM) -> Report:
    """Validate one launch against the signature table and the kernels'
    contract (``geom.args``: the values a recorded call passed)."""
    report = Report(name=name)
    where = f"{geom.kernel} grid={geom.grid} threads={geom.threads}"

    report.mark_checked("KG-PREFETCH-ARITY")
    sig = KERNEL_SIGNATURES.get(geom.kernel)
    if sig is None:
        report.add("KG-PREFETCH-ARITY",
                   f"unknown kernel entry {geom.kernel!r} — not in "
                   f"_build.KERNEL_SIGNATURES", where)
        return report
    if geom.args is not None:
        if len(geom.args) != len(sig.args):
            report.add(
                "KG-PREFETCH-ARITY",
                f"call site passes {len(geom.args)} argument(s), the "
                f"entry's signature takes {len(sig.args)} "
                f"({', '.join(sig.args)})", where)
        else:
            bad = [f"{a}={v!r} ({k})" for a, k, v
                   in zip(sig.args, sig.kinds, geom.args) if not _fits(k, v)]
            if bad:
                report.add(
                    "KG-PREFETCH-ARITY",
                    f"argument(s) outside their C type: {', '.join(bad)}",
                    where)
            passed = dict(zip(sig.args, geom.args))
            grid_arg = next((a for a in _GRID_ARGS if a in passed), None)
            if grid_arg and passed[grid_arg] != geom.grid[0]:
                report.add(
                    "KG-PREFETCH-ARITY",
                    f"the call launched {grid_arg}={passed[grid_arg]!r} "
                    f"blocks, its geometry a grid of {geom.grid[0]}", where)

    report.mark_checked("KG-SMEM-TABLE")
    if sig.grouped and geom.table_rows is not None:
        if expected_groups is not None and geom.table_rows != expected_groups:
            report.add(
                "KG-SMEM-TABLE",
                f"format table has {geom.table_rows} rows for "
                f"{expected_groups} group(s) — tiles would resolve formats "
                f"out of the wrong row (or read past the table)", where)
        if (geom.tile_group_len is not None and geom.tiles is not None
                and geom.tile_group_len != geom.tiles):
            report.add(
                "KG-SMEM-TABLE",
                f"tile -> group map has {geom.tile_group_len} entries for "
                f"{geom.tiles} tile(s)", where)
    if geom.table_bytes > SMEM_TABLE_BUDGET_BYTES:
        report.add(
            "KG-SMEM-TABLE",
            f"format table and tile map take {geom.table_bytes} B (budget "
            f"{SMEM_TABLE_BUDGET_BYTES} B) — an over-tall table signals a "
            f"mis-built layout", where)
    if geom.smem_bytes > smem_budget:
        report.add(
            "KG-SMEM-TABLE",
            f"a block asks for {geom.smem_bytes} B of shared memory, the "
            f"card gives at most {smem_budget} B", where)

    report.mark_checked("KG-TILE-MIN")
    if sig.grouped and geom.quantum is not None \
            and geom.quantum % MIN_GROUP_QUANTUM:
        report.add(
            "KG-TILE-MIN",
            f"grouped quantum {geom.quantum} is not a multiple of "
            f"{MIN_GROUP_QUANTUM} (one 16-byte int8 vector)", where)
    if geom.threads < WARP or geom.threads % WARP:
        report.add(
            "KG-TILE-MIN",
            f"a block of {geom.threads} threads is not whole warps of "
            f"{WARP}", where)
    return report


def check_layout(layout, name: str = "group-layout") -> Report:
    """Prove the :class:`~repro_torch.dist.collectives.GroupLayout` tiling
    contract on a built layout (anything with its fields: ``group_sizes``,
    ``quantum``, ``n_chunks``, ``padded``, ``offsets``, ``chunk``,
    ``total``)."""
    report = Report(name=name)
    report.mark_checked("KG-TILE-STRADDLE")
    q = layout.quantum
    where = (f"groups={len(layout.group_sizes)} quantum={q} "
             f"chunks={layout.n_chunks}")

    off = 0
    for g, (size, padded, offset) in enumerate(
            zip(layout.group_sizes, layout.padded, layout.offsets)):
        if offset != off:
            report.add(
                "KG-TILE-STRADDLE",
                f"group {g} starts at offset {offset}, expected the "
                f"cumulative padded offset {off} — its first tile would "
                f"straddle the previous group", where)
        if offset % q:
            report.add(
                "KG-TILE-STRADDLE",
                f"group {g} offset {offset} is not tile-aligned "
                f"(quantum {q})", where)
        if padded < size:
            report.add(
                "KG-TILE-STRADDLE",
                f"group {g} padded slot {padded} is smaller than its "
                f"{size}-element payload", where)
        if padded % q:
            report.add(
                "KG-TILE-STRADDLE",
                f"group {g} padded slot {padded} is not a quantum "
                f"multiple — the group's last tile would straddle into "
                f"group {g + 1}", where)
        off = offset + padded

    if layout.chunk % q:
        report.add(
            "KG-TILE-STRADDLE",
            f"rank chunk {layout.chunk} is not a quantum multiple — an "
            f"all-to-all boundary would split a tile across ranks", where)
    if layout.total != layout.n_chunks * layout.chunk:
        report.add(
            "KG-TILE-STRADDLE",
            f"total {layout.total} ≠ n_chunks {layout.n_chunks} × chunk "
            f"{layout.chunk}", where)
    if layout.total < off:
        report.add(
            "KG-TILE-STRADDLE",
            f"total {layout.total} cannot hold the {off} aligned payload "
            f"elements", where)
    return report


def check_launches(trace, name: str = "launches",
                   smem_budget: int = RED_MAX_SMEM) -> Report:
    """:func:`check_call` on every launch a trace recorded, merged."""
    report = Report(name=name)
    report.mark_checked("KG-PREFETCH-ARITY", "KG-SMEM-TABLE", "KG-TILE-MIN")
    for node in trace.of_kind("kernel"):
        report.merge(check_call(KernelCallGeometry.from_launch(node),
                                name=node.where, smem_budget=smem_budget))
    return report
