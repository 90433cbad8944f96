"""Peak device memory (port of ``tools/snapshot_max_memory.py``).

With a path, reads a memory profile: a ``torch.cuda.memory._snapshot()``
pickle (``torch.cuda.memory._dump_snapshot``, the CUDA allocator's own
format) and prints the peak it holds; any other file is read as a pprof
device-memory profile, gzipped or not, whose samples' last values are
summed. Without a path, prints the live allocator statistics of each CUDA
device.

    python -m vision_pt_tpu_torch.tools.snapshot_max_memory [PROFILE]
"""

from __future__ import annotations

import gzip
import pickle
from pathlib import Path

import click


def format_bytes(size: float) -> str:
    for unit in ["B", "KB", "MB", "GB", "TB"]:
        if size < 1024:
            return f"{size:.2f} {unit}"
        size /= 1024
    return f"{size:.2f} PB"


def profile_total_bytes(path: str) -> int:
    """Sum the last value of every sample of a pprof profile: a varint walk
    over the length-delimited proto (field 2, Sample; its field 2, values),
    so no protobuf package is needed."""
    raw = Path(path).read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    total = 0
    i = 0

    def read_varint(buf, pos):
        shift = 0
        val = 0
        while True:
            b = buf[pos]
            val |= (b & 0x7F) << shift
            pos += 1
            if not b & 0x80:
                return val, pos
            shift += 7

    while i < len(raw):
        try:
            key, i = read_varint(raw, i)
        except IndexError:
            break
        field, wire = key >> 3, key & 7
        if wire == 2:
            ln, i = read_varint(raw, i)
            chunk = raw[i:i + ln]
            i += ln
            if field == 2:  # Sample
                j = 0
                vals = []
                while j < len(chunk):
                    skey, j = read_varint(chunk, j)
                    sfield, swire = skey >> 3, skey & 7
                    if swire == 0:
                        v, j = read_varint(chunk, j)
                        if sfield == 2:
                            vals.append(v)
                    elif swire == 2:
                        sln, j = read_varint(chunk, j)
                        j += sln
                    else:
                        break
                if vals:
                    total += vals[-1]
        elif wire == 0:
            _, i = read_varint(raw, i)
        else:
            break
    return total


def snapshot_peak_bytes(snapshot: dict) -> int:
    """The most bytes allocated at once in a ``torch.cuda.memory._snapshot()``:
    the allocated blocks' sum at the snapshot, walked back through each
    device's trace of allocations and frees (a trace that starts after the
    snapshot's first allocation is read from the snapshot's state)."""
    live = sum(block["size"] for segment in snapshot.get("segments", [])
               for block in segment.get("blocks", [])
               if block.get("state") == "active_allocated")
    peak = live
    for trace in snapshot.get("device_traces", []):
        current = live
        for event in reversed(trace):  # undo the trace from the end
            if event["action"] == "alloc":
                current -= event["size"]
            elif event["action"] == "free_completed":
                current += event["size"]
            peak = max(peak, current)
    return peak


def read_profile_bytes(path: str) -> tuple[str, int]:
    """(kind, bytes): the peak of an allocator snapshot pickle, else the
    live bytes of a pprof profile."""
    raw = Path(path).read_bytes()
    if raw[:1] == b"\x80":  # a pickle
        return "allocator snapshot peak", snapshot_peak_bytes(pickle.loads(raw))
    return "profiled live bytes", profile_total_bytes(path)


def live_stats() -> list[dict]:
    """Each CUDA device's allocator statistics: in use, peak and the
    device's total."""
    import torch

    out = []
    for index in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats = torch.cuda.memory_stats(index)
        out.append({"device": f"cuda:{index}",
                    "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                    "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                    "bytes_limit": torch.cuda.get_device_properties(index).total_memory})
    return out


@click.command()
@click.argument("profile_path", required=False,
                type=click.Path(exists=True))
def main(profile_path: str | None) -> None:
    if profile_path:
        kind, total = read_profile_bytes(profile_path)
        print(f"{kind}: {format_bytes(float(total))}")
        return
    stats = live_stats()
    if not stats:
        print("no CUDA device: no memory stats available")
    for s in stats:
        print(
            f"{s['device']}: in_use={format_bytes(s['bytes_in_use'])} "
            f"peak={format_bytes(s['peak_bytes_in_use'])} "
            f"limit={format_bytes(s['bytes_limit'])}"
        )


if __name__ == "__main__":
    main()
