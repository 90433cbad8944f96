"""Danbooru tag formatting (the port's own copy of
``vision_pt_tpu/data/tags.py``)."""

from __future__ import annotations


def _num_object(num: int, noun: str) -> str:
    return f"{num}{'+' if num == 6 else ''}{noun}{'s' if num > 1 else ''}"


PEOPLE_TAGS = [
    *[_num_object(i, "girl") for i in range(1, 7)],
    *[_num_object(i, "boy") for i in range(1, 7)],
    *[_num_object(i, "other") for i in range(1, 7)],
]


def format_general_character_tags(
    general: list[str],
    character: list[str],
    rating: str,
    separator: str = ", ",
    group_separator: str = "|||",
    score: int | None = None,
) -> str:
    """people ||| character ||| general ||| rating ||| quality groups."""
    people_tags = [t for t in general if t in PEOPLE_TAGS]
    general_tags = [t for t in general if t not in PEOPLE_TAGS]

    rating_tags = []
    if rating in ("explicit", "e", "questionable", "q"):
        rating_tags.append("nsfw")
        if rating in ("explicit", "e"):
            rating_tags.append("explicit")
    else:
        rating_tags.append("safe")

    quality_tags = []
    if score is not None:
        if score >= 50:
            quality_tags.append("masterpiece")
        elif score >= 25:
            quality_tags.append("best_quality")
        elif score >= 5:
            quality_tags.append("high_quality")
        elif score < 0:
            quality_tags.append("worst_quality")
        else:
            quality_tags.append("low_quality")

    return group_separator.join(
        part
        for part in [
            separator.join(people_tags),
            separator.join(character),
            separator.join(general_tags),
            separator.join(rating_tags),
            separator.join(quality_tags),
        ]
        if part.strip() != ""
    )


KAOMOJI = [
    ">_<", ">_o", "0_0", "o_o", "3_3", "6_9", "@_@", "u_u", "x_x", "^_^",
    "|_|", "=_=", "+_+", "+_-", "._.", "<o>_<o>", "<|>_<|>",
    "||_||", "(o)_(o)",
]


def replace_underscore(tag: str) -> str:
    """Underscore -> space, kaomoji-safe."""
    if tag in KAOMOJI:
        return tag
    return tag.replace("_", " ")


def map_replace_underscore(tags: list[str]) -> list[str]:
    return [replace_underscore(tag) for tag in tags]
