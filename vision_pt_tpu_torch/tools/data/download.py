"""Dataset download entry points (port of ``tools/data/download.py``):

    python -m vision_pt_tpu_torch.tools.data.download konachan -o OUT --limit N --mirror DIR
    python -m vision_pt_tpu_torch.tools.data.download safebooru-parquet -i META -o OUT --mirror DIR
    python -m vision_pt_tpu_torch.tools.data.download safebooru --output OUT --metadata-parquet META --mirror DIR
    python -m vision_pt_tpu_torch.tools.data.download styled-images --metadata META --images_dir DIR --mirror DIR

Selection, filtering and the dataset layout are ``data/datapool.py``'s; the
image bytes come from ``--mirror``, a local folder of ``<id>.<ext>`` files.
Without ``--mirror`` the HF pool is chosen, which raises: nothing is
fetched from the network.
"""

from pathlib import Path

import click

from ...data.datapool import (
    HFDataPool,
    LocalMirrorPool,
    download_posts,
    filter_posts_parquet,
    select_styled_pair_ids,
    select_trailing_ids,
)

KONACHAN_MAX_ID = 391069  # reference dl_konachan.py:7


def _pool(mirror: str | None):
    return LocalMirrorPool(mirror) if mirror else HFDataPool()


@click.group()
def main():
    pass


@main.command()
@click.option("--output", "-o", type=str, required=True)
@click.option("--limit", type=int, required=True)
@click.option("--mirror", type=str, default=None,
              help="local image mirror directory (offline byte source)")
@click.option("--max-id", type=int, default=KONACHAN_MAX_ID)
def konachan(output: str, limit: int, mirror: str | None, max_id: int):
    """Newest-``limit`` posts by trailing id range (reference
    ``dl_konachan.py``)."""
    n = download_posts(
        _pool(mirror),
        select_trailing_ids(max_id, limit),
        Path(output) / "images",
        write_metadata=False,
    )
    print(f"downloaded {n} images to {output}/images")


@main.command(name="safebooru-parquet")
@click.option("--parquet-path", "-i", type=str, required=True)
@click.option("--output-path", "-o", type=str, required=True)
@click.option("--start-date", type=str, default="2020-01-01")
@click.option("--end-date", type=str, default="2025-12-31",
              help="EXCLUSIVE upper bound (reference uses a half-open "
                   "[start, end) window)")
@click.option("--limit", "-l", type=int, default=1000)
@click.option("--mirror", type=str, default=None)
def safebooru_parquet(parquet_path: str, output_path: str, start_date: str,
                      end_date: str, limit: int, mirror: str | None):
    """Filter a danbooru2024-style metadata parquet (date window, no
    animated/duplicate/lowres/watermark meta tags), write the filtered
    cache parquet + per-post JSON, fetch the images (reference
    ``dl_safebooru_parquet.py``)."""
    out = Path(output_path)
    out.mkdir(parents=True, exist_ok=True)
    cache = out / "cache.parquet"
    if cache.exists():
        # resume: the filtered selection is the cache — skip re-filtering
        # the full (possibly GB-scale) metadata parquet. Reference
        # semantics (dl_safebooru_parquet.py:46): the cache wins even when
        # the filter arguments changed — say so loudly.
        import pyarrow.parquet as pq

        print(f"using cached selection {cache} — current filter args "
              "(--limit/--start-date/--end-date/-i) are IGNORED; delete "
              "the cache to re-filter")
        table = pq.read_table(cache)
    else:
        table = filter_posts_parquet(
            parquet_path, start_date, end_date, limit,
            cache_parquet_path=cache,
        )
    posts = {int(row["id"]): row for row in table.to_pylist()}
    print(f"selected {len(posts)} posts")
    n = download_posts(_pool(mirror), posts, out / "images")
    print(f"downloaded {n} images to {out / 'images'}")


@main.command()
@click.option("--output", type=str, required=True)
@click.option("--metadata-parquet", type=str, required=True,
              help="local danbooru-style metadata parquet (the reference "
                   "queries the Danbooru API instead, which needs egress)")
@click.option("--limit", type=int, default=1000)
@click.option("--start-date", type=str, default="2021-01-01")
@click.option("--end-date", type=str, default="2024-08-31",
              help="EXCLUSIVE upper bound (half-open [start, end) window)")
@click.option("--mirror", type=str, default=None)
def safebooru(output: str, metadata_parquet: str, limit: int,
              start_date: str, end_date: str, mirror: str | None):
    """Date-windowed post selection + image/JSON layout (reference
    ``dl_safebooru.py``; the id *query* runs against local metadata here)."""
    table = filter_posts_parquet(metadata_parquet, start_date, end_date,
                                 limit)
    posts = {int(row["id"]): row for row in table.to_pylist()}
    print(f"selected {len(posts)} posts")
    n = download_posts(_pool(mirror), posts, Path(output) / "images")
    print(f"downloaded {n} images to {output}/images")


@main.command(name="styled-images")
@click.option("--metadata", type=str, required=True)
@click.option("--images_dir", type=str, required=True)
@click.option("--debug", is_flag=True, default=False)
@click.option("--mirror", type=str, default=None)
def styled_images(metadata: str, images_dir: str, debug: bool,
                  mirror: str | None):
    """Fetch the ``another_id`` style-pair images referenced by a styled
    dataset's metadata parquet (reference ``dl_styled_images.py``)."""
    images = Path(images_dir)
    images.mkdir(parents=True, exist_ok=True)
    ids = select_styled_pair_ids(metadata, images)
    if debug:
        ids = ids[:20]
    print(f"Found {len(ids)} posts to download.")
    n = download_posts(_pool(mirror), ids, images, write_metadata=False)
    print(f"downloaded {n} images to {images}")


if __name__ == "__main__":
    main()
