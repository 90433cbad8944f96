"""Dataset acquisition pools and post selection (port of
``vision_pt_tpu/data/datapool.py``).

Image bytes come through an injectable pool:

- :class:`LocalMirrorPool` serves ``<root>/<id>.<ext>`` files: the layout one
  cheesechaser run on a host with network access produces, or any copied
  dataset mirror. Every selection, filter and layout step runs against it.
- :class:`HFDataPool` is the path that needs the network; constructing it
  raises with the recipe for such a host instead of opening a socket.

The selection logic: the date window and meta-tag filter of a
danbooru2024-style metadata parquet (pyarrow, imported where it is used),
the trailing id range, and the exploded ``another_id`` style pairs.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Iterable, Iterator, Protocol

_IMAGE_EXTS = (".webp", ".png", ".jpg", ".jpeg")

_META_EXCLUDE_TAGS = (
    # reference dl_safebooru_parquet.py:72-76
    "animated",
    "duplicate",
    "pixel-perfect_duplicate",
    "lowres",
    "watermark",
)


class DataPool(Protocol):
    def batch_fetch(self, ids: Iterable[int]) -> Iterator[tuple[int, Path]]:
        """Yield (post_id, local_file_path) for every id that could be
        fetched; silently skip missing ids (reference pools do the same)."""
        ...


class LocalMirrorPool:
    """Serves image files from a local mirror directory."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        if not self.root.is_dir():
            raise FileNotFoundError(
                f"mirror directory {self.root} does not exist"
            )

    def _find(self, post_id: int) -> Path | None:
        for ext in _IMAGE_EXTS:
            p = self.root / f"{post_id}{ext}"
            if p.exists():
                return p
        return None

    def batch_fetch(self, ids: Iterable[int]) -> Iterator[tuple[int, Path]]:
        for post_id in ids:
            path = self._find(int(post_id))
            if path is not None:
                yield int(post_id), path


class HFDataPool:
    """The network path (cheesechaser's pools). Nothing here fetches from
    the network, so constructing it raises with the recipe for a host that
    can."""

    RECIPE = """\
Run on a host with egress (pip install cheesechaser), e.g. for danbooru:
    from cheesechaser.datapool import Danbooru2024WebpDataPool
    Danbooru2024WebpDataPool().batch_download_to_directory(
        resource_ids=ids, dst_dir=mirror_dir)
then point --mirror at mirror_dir (or copy it next to the training hosts)."""

    def __init__(self, name: str = "danbooru2024-webp"):
        raise RuntimeError(
            f"HF datapool {name!r} needs network egress; nothing in this "
            f"package fetches from the network.\n{self.RECIPE}"
        )


def select_trailing_ids(max_id: int, limit: int) -> range:
    """Trailing id range, END-EXCLUSIVE of ``max_id`` itself — matching the
    reference's ``range(max(1, MAX_ID - limit), MAX_ID)`` exactly
    (``dl_konachan.py:7-24``), which also never fetches the max post."""
    return range(max(1, max_id - limit), max_id)


def filter_posts_parquet(
    parquet_path: str | Path,
    start_date: str,
    end_date: str,
    limit: int,
    cache_parquet_path: str | Path | None = None,
):
    """Date-window + meta-tag filter of a danbooru2024-style metadata
    parquet; returns a pyarrow Table of the selected posts and optionally
    writes the filtered cache parquet (reference
    ``dl_safebooru_parquet.py:44-85``). Semantics pinned to the reference:

    - date window is HALF-OPEN [start, end) (polars ``closed="left"``);
    - rows with a NULL ``tag_string_meta`` are dropped (the reference's
      ``~null.list.contains(...)`` is Kleene-null and polars ``filter``
      drops null-mask rows);
    - first ``limit`` matching rows in file order.

    The parquet is streamed batch-wise and the scan stops as soon as
    ``limit`` rows matched — a multi-GB metadata file is never fully
    materialized (the reference's ``pl.scan_parquet`` lazy frame does the
    same)."""
    import datetime as _dt

    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    lo = _dt.datetime.fromisoformat(start_date)
    hi = _dt.datetime.fromisoformat(end_date)

    def _batch_mask(batch):
        created = pc.strptime(
            pc.utf8_slice_codeunits(batch["created_at"], 0, 19),
            format="%Y-%m-%dT%H:%M:%S",
            unit="s",
        )
        mask = pc.and_(pc.greater_equal(created, lo), pc.less(created, hi))
        if "tag_string_meta" in batch.schema.names:
            meta = batch["tag_string_meta"]

            def _has_token(tag: str):
                # whole-token match on the space-separated tag string (the
                # reference splits to a list and uses list.contains)
                return pc.or_(
                    pc.or_(pc.equal(meta, tag),
                           pc.starts_with(meta, f"{tag} ")),
                    pc.or_(pc.ends_with(meta, f" {tag}"),
                           pc.match_substring(meta, f" {tag} ")),
                )

            for tag in _META_EXCLUDE_TAGS:
                mask = pc.and_(mask, pc.invert(_has_token(tag)))
        return mask

    pf = pq.ParquetFile(parquet_path)
    kept = []
    remaining = limit
    for batch in pf.iter_batches():
        if remaining <= 0:
            break
        filtered = pa.Table.from_batches([batch]).filter(_batch_mask(batch))
        if filtered.num_rows:
            kept.append(filtered.slice(0, remaining))
            remaining -= min(filtered.num_rows, remaining)
    out = (
        pa.concat_tables(kept) if kept
        else pa.Table.from_batches([], schema=pf.schema_arrow)
    )
    if cache_parquet_path is not None:
        pq.write_table(out, cache_parquet_path)
    return out


def select_styled_pair_ids(
    metadata_parquet: str | Path, images_dir: str | Path
) -> list[int]:
    """Unique exploded ``another_id`` values not yet present in
    ``images_dir`` (reference ``dl_styled_images.py:33-58``)."""
    import pyarrow.parquet as pq

    table = pq.read_table(metadata_parquet, columns=["another_id"])
    ids: set[int] = set()
    for chunk in table["another_id"].chunks:
        for row in chunk:
            value = row.as_py()
            if value is None:
                continue
            if isinstance(value, list):
                ids.update(int(v) for v in value if v is not None)
            else:
                ids.add(int(value))
    images = Path(images_dir)
    return sorted(
        i for i in ids
        if not any((images / f"{i}{e}").exists() for e in _IMAGE_EXTS)
    )


def download_posts(
    pool: DataPool,
    posts: dict[int, dict] | Iterable[int],
    images_dir: str | Path,
    write_metadata: bool = True,
) -> int:
    """Fetch every post through ``pool`` into the dataset layout the
    text-to-image datasets consume: ``images/<id>.<ext>`` plus
    ``images/<id>.json`` metadata (reference ``dl_safebooru.py:44-51``,
    ``dl_safebooru_parquet.py:96-127``). Returns the number written.

    Resume semantics: an id is skipped only when its image AND (when
    metadata is requested) its ``.json`` are both present — and the JSON is
    written BEFORE the image copy (the reference writes all JSON up front),
    so a crash between the two writes can never leave an image that resume
    would skip while its metadata is missing forever."""
    images = Path(images_dir)
    images.mkdir(parents=True, exist_ok=True)
    if isinstance(posts, dict):
        meta = posts
        ids = list(posts.keys())
    else:
        meta = {}
        ids = list(posts)
    existing = {
        int(p.stem) for p in images.iterdir()
        if p.suffix in _IMAGE_EXTS and p.stem.isdigit()
    }

    def _complete(i: int) -> bool:
        if i not in existing:
            return False
        if write_metadata and i in meta:
            return (images / f"{i}.json").exists()
        return True

    todo = [i for i in ids if not _complete(int(i))]
    written = 0
    for post_id, src in pool.batch_fetch(todo):
        if write_metadata and post_id in meta:
            (images / f"{post_id}.json").write_text(
                json.dumps(meta[post_id], indent=2, ensure_ascii=False,
                           default=str)
            )
        shutil.copyfile(src, images / f"{post_id}{src.suffix}")
        written += 1
    return written
