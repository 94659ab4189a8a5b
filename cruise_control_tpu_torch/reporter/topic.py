"""(Counterpart of ``cruise_control_tpu/reporter/topic.py``, with the port's imports.)
File-backed metrics topic: the __CruiseControlMetrics transport.

Reference role: the Kafka topic the in-broker reporter produces to and
CruiseControlMetricsReporterSampler consumes from. Zero-dependency stand-in:
a length-prefixed append-only log file with offset-based consumption — the
same at-least-once, ordered, replayable contract a single-partition Kafka
topic gives the reference (consumers seek to an offset and poll forward).
"""
from __future__ import annotations

import os
import struct
import threading

_LEN = struct.Struct(">I")


class FileMetricsTopic:
    def __init__(self, path: str):
        self._path = path
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(path):
            open(path, "wb").close()

    def append(self, records: list[bytes]) -> None:
        """Producer side (reporter)."""
        with self._lock, open(self._path, "ab") as f:
            for r in records:
                f.write(_LEN.pack(len(r)))
                f.write(r)

    def consume(self, offset: int = 0, max_records: int | None = None):
        """Consumer side: yields (next_offset, record) from byte ``offset``
        forward (KafkaConsumer.seek + poll contract)."""
        out = []
        with self._lock, open(self._path, "rb") as f:
            f.seek(offset)
            while max_records is None or len(out) < max_records:
                head = f.read(_LEN.size)
                if len(head) < _LEN.size:
                    break
                (n,) = _LEN.unpack(head)
                payload = f.read(n)
                if len(payload) < n:
                    break   # torn tail write: wait for the producer to finish
                out.append((f.tell(), payload))
        return out

    @property
    def end_offset(self) -> int:
        with self._lock:
            return os.path.getsize(self._path)
