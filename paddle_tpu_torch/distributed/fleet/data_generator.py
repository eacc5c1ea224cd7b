"""Fleet data generators — a copy of
``paddle_tpu/distributed/fleet/data_generator.py``.

Reference parity: ``distributed/fleet/data_generator/data_generator.py`` —
user subclasses override ``generate_sample`` (line -> [(slot_name,
[values]), ...]); the generator renders MultiSlot text lines the native
dataset engine ingests (csrc/dataset.cc mirrors MultiSlotDataFeed).
"""
from __future__ import annotations

import sys


class DataGenerator:
    def __init__(self):
        self.batch_size_ = 32
        self._proto_info = None

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    def generate_sample(self, line):
        raise NotImplementedError(
            "rewrite generate_sample to return an iterator factory over "
            "[(name, [feasign, ...]), ...] records")

    def generate_batch(self, samples):
        def local_iter():
            for sample in samples:
                yield sample

        return local_iter

    def _gen_str(self, line):
        raise NotImplementedError(
            "use MultiSlotDataGenerator or MultiSlotStringDataGenerator")

    def run_from_memory(self):
        """Generate from generate_sample(None) and print slot lines."""
        batch_samples = []
        fn = self.generate_sample(None)
        for sample in fn():
            batch_samples.append(sample)
            if len(batch_samples) == self.batch_size_:
                for s in self.generate_batch(batch_samples)():
                    sys.stdout.write(self._gen_str(s))
                batch_samples = []
        if batch_samples:
            for s in self.generate_batch(batch_samples)():
                sys.stdout.write(self._gen_str(s))

    def run_from_stdin(self):
        """Pipe mode: one input line -> slot-formatted output lines."""
        batch_samples = []
        for line in sys.stdin:
            fn = self.generate_sample(line)
            for sample in fn():
                batch_samples.append(sample)
                if len(batch_samples) == self.batch_size_:
                    for s in self.generate_batch(batch_samples)():
                        sys.stdout.write(self._gen_str(s))
                    batch_samples = []
        if batch_samples:
            for s in self.generate_batch(batch_samples)():
                sys.stdout.write(self._gen_str(s))


class MultiSlotDataGenerator(DataGenerator):
    """Numeric slots: '<n> v1 ... vn' per slot, space-joined
    (reference: MultiSlotDataGenerator._gen_str)."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "generate_sample must yield [(name, [value, ...]), ...]")
        parts = []
        for _name, values in line:
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return " ".join(parts) + "\n"


class MultiSlotStringDataGenerator(DataGenerator):
    """String feasigns: '<n> s1 ... sn' per slot
    (reference: MultiSlotStringDataGenerator._gen_str)."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "generate_sample must yield [(name, [str, ...]), ...]")
        parts = []
        for _name, values in line:
            parts.append(str(len(values)))
            parts.extend(values)
        return " ".join(parts) + "\n"
