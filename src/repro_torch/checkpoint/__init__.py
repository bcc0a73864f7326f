"""Checkpoints of the port (`repro.checkpoint`), in the reference's
on-disk format."""
from .manager import AsyncCheckpointer, latest_step, restore, rotate, save

__all__ = ["save", "restore", "latest_step", "rotate", "AsyncCheckpointer"]
