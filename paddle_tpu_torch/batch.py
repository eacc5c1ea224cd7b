"""paddle.batch (reference: python/paddle/batch.py) — batched reader
combinator for the 1.x generator-reader style; counterpart of
``paddle_tpu/batch.py``."""
from __future__ import annotations


def batch(reader, batch_size, drop_last=False):
    def batch_reader():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    if batch_size <= 0:
        raise ValueError("batch_size should be a positive integer")
    return batch_reader
