"""In-memory list dataset with a loop multiplier (a copy of JAX
``data/simple.py``; reference dataloaders/SimpleDataset.py:11-61; used by
TTT-style fine-tuning flows)."""

from __future__ import annotations


class SimpleDataset:
    def __init__(self, items: list, loops: int = 1):
        self.items = list(items)
        self.loops = loops

    def __len__(self):
        return len(self.items) * self.loops

    def __getitem__(self, idx):
        return self.items[idx % len(self.items)]
