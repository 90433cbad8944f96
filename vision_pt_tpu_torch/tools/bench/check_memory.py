"""Device-memory checker (port of ``tools/bench/check_memory.py``): prints
each CUDA device's allocator statistics, then runs a Python expression
(``--expr``, with ``torch`` in scope) and prints them again.

    python -m vision_pt_tpu_torch.tools.bench.check_memory \\
        --expr "torch.zeros(8192, 8192, device='cuda')"
"""

from __future__ import annotations

import click

from ..snapshot_max_memory import format_bytes, live_stats


def report(label: str) -> list[dict]:
    """Print and return each CUDA device's statistics (in use, peak,
    total), as ``snapshot_max_memory.live_stats`` reads them."""
    stats = live_stats()
    if not stats:
        print(f"[{label}] no CUDA device: no memory stats")
    for s in stats:
        print(
            f"[{label}] {s['device']}: "
            f"in_use={format_bytes(s['bytes_in_use'])} "
            f"peak={format_bytes(s['peak_bytes_in_use'])} "
            f"limit={format_bytes(s['bytes_limit'])}"
        )
    return stats


@click.command()
@click.option("--expr", type=str, default=None,
              help="python expression to execute between the two reports, "
                   "e.g. \"torch.zeros(8192, 8192, device='cuda')\"")
def main(expr: str | None):
    import torch

    report("before")
    if expr:
        eval(expr, {"torch": torch})  # noqa: S307 - explicit user-supplied probe
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        report("after")


if __name__ == "__main__":
    main()
