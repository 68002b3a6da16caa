"""Compact row and partition identifiers.

Parity with reference table/primary_id.rs and table/partition_id.rs:

- PrimaryId: u64 = (16-bit epoch << 48) | 48-bit slot. The slot indexes the
  row's position in columnar storage (and the device vector array); the epoch
  increments on every row update so stale index hits are rejected after the
  fact (the device-side validity check compares epochs).
- PartitionId: u64 = (16-bit IndexId << 48) | 48-bit slot. IndexId's MSB is
  the GLOBAL bit marking a single-partition (global) index.
"""

from __future__ import annotations

from dataclasses import dataclass

_EPOCH_SHIFT = 48
_SLOT_MASK = (1 << 48) - 1
_EPOCH_MAX = (1 << 16) - 1

_GLOBAL_BIT = 1 << 15
_INDEX_ID_MAX = _GLOBAL_BIT - 1  # 0x7fff; also the exhaustion sentinel


@dataclass(frozen=True, order=True)
class PrimaryId:
    value: int

    @staticmethod
    def new(slot: int, epoch: int) -> "PrimaryId":
        if not (0 <= slot <= _SLOT_MASK):
            raise ValueError(f"PrimaryId slot too large: {slot}")
        if not (0 <= epoch <= _EPOCH_MAX):
            raise ValueError(f"epoch out of range: {epoch}")
        return PrimaryId((epoch << _EPOCH_SHIFT) | slot)

    @property
    def slot(self) -> int:
        return self.value & _SLOT_MASK

    @property
    def epoch(self) -> int:
        return self.value >> _EPOCH_SHIFT

    def with_epoch(self, epoch: int) -> "PrimaryId":
        return PrimaryId.new(self.slot, epoch)


def next_epoch(epoch: int) -> int:
    """Cyclic epoch increment (primary_id.rs:80-88). Epochs wrap after 65535
    updates of the same slot; stale ids older than a full cycle could alias,
    which the reference accepts (one change/ms gives ~65 s of uniqueness)."""
    return 0 if epoch >= _EPOCH_MAX else epoch + 1


@dataclass(frozen=True, order=True)
class IndexId:
    value: int

    @staticmethod
    def local(id_: int) -> "IndexId":
        if not (0 <= id_ <= _INDEX_ID_MAX):
            raise ValueError(f"IndexId too large for local: {id_}")
        return IndexId(id_)

    @staticmethod
    def global_(id_: int) -> "IndexId":
        if not (0 <= id_ <= _INDEX_ID_MAX):
            raise ValueError(f"IndexId too large for global: {id_}")
        return IndexId(id_ | _GLOBAL_BIT)

    @property
    def is_global(self) -> bool:
        return bool(self.value & _GLOBAL_BIT)


class IndexIdGenerator:
    """Allocates IndexIds for the (possibly several) indexes sharing a Table
    (partition_id.rs:78-101)."""

    def __init__(self) -> None:
        self._next = 0

    def next(self, global_: bool) -> IndexId:
        if self._next == _INDEX_ID_MAX:
            raise RuntimeError("No more IndexIds available")
        index_id = IndexId.global_(self._next) if global_ else IndexId.local(self._next)
        self._next += 1
        return index_id


@dataclass(frozen=True, order=True)
class PartitionId:
    value: int

    @staticmethod
    def new(slot: int, index_id: IndexId) -> "PartitionId":
        if not (0 <= slot <= _SLOT_MASK):
            raise ValueError(f"PartitionId slot too large: {slot}")
        return PartitionId((index_id.value << _EPOCH_SHIFT) | slot)

    @staticmethod
    def global_for(index_id: IndexId) -> "PartitionId":
        return PartitionId(index_id.value << _EPOCH_SHIFT)

    @property
    def slot(self) -> int:
        return self.value & _SLOT_MASK

    @property
    def index_id(self) -> IndexId:
        return IndexId(self.value >> _EPOCH_SHIFT)
