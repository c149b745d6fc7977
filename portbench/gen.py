"""The benchmark's input generators, vectorised with NumPy.

Every input is a function of ``(kind, seed, index)`` alone, through
``numpy.random.default_rng([seed, index, part])`` (:func:`rng`), so the
same seed gives the same bytes on any machine.

A configuration's ``data`` names its generator (:func:`inputs`): an entry
of ``DATA`` (with its strings in ``FIELDS``), or a file
``portbench/inputs/<data>.py`` of its own that defines

- ``make(n: int, seed: int, index: int, cfg: dict) -> np.ndarray``: ``n``
  bytes, uint8, the bulk patterns' object ``index``;
- for the ``strings`` pattern, ``fields(count: int, seed: int, index: int,
  cfg: dict) -> list[bytes]``: ``count`` strings.

``cfg`` is the configuration as ``harness.resolve`` returns it, its
``table_path`` included, so that a generator can read the table
(``reference.huffman_np.parse_tsv``), as a corpus matched to it must. A
file generator draws its randomness only through :func:`rng`.

``canterbury_like`` copies the construction of the port's
``tpu_huffman_torch/corpora.py`` (itself a copy of the JAX package's
``corpora.py``): equal slices of six classes shaped like the Canterbury
corpus's files. Each class keeps its generator's byte statistics (word
list and Zipf weights, punctuation rates, tag and keyword sets, digit
grids, opcode-like bytes with zero runs, fax runs with ragged edges), but
draws all of its random numbers at once, so 8 MiB take well under a
second where the per-word loop takes tens. The bytes differ from
``corpora.py``'s.

``header_fields`` copies ``hpack_header_corpus`` of ``bench_suite.py``:
header names and values drawn as it draws them, each name and each value
a string of its own, as HPACK codes them.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np

from . import named

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "inputs")

_WORDS = (
    "the of and a to in is was he for it with as his on be at by i this had "
    "not are but from or have an they which one you were her all she there "
    "would their we him been has when who will more no if out so said what "
    "up its about into than them can only other new some could time these "
    "two may then do first any my now such like our over man me even most "
    "made after also did many before must through back years where much "
    "your way well down should because each just those people mr how too "
    "little state good very make world still own see men work long get "
    "here between both life being under never day same another know while "
    "last might us great old year off come since against go came right "
    "used take three"
).split()

_KEYWORDS = (
    "int char void static const struct return if else for while size_t "
    "uint32_t uint8_t break continue switch case default sizeof"
).split()

_TAGS = ["p", "a", "li", "td", "tr", "h2", "em", "div", "span", "code"]

_HEADER_NAMES = [b"content-type", b":authority", b":path", b"accept-encoding",
                 b"user-agent", b"cache-control", b"x-amz-request-id", b"etag",
                 b"date", b"content-length", b"x-forwarded-for", b"cookie"]
_HEADER_WORDS = [b"text/html; charset=utf-8", b"gzip, deflate, br",
                 b"max-age=31536000, immutable", b"www.example.com",
                 b"application/json", b"keep-alive", b"/index.html",
                 b"Mozilla/5.0 (X11; Linux x86_64) AppleWebKit/537.36",
                 b"no-cache", b"session=abc123def456; path=/; httponly"]


def rng(seed: int, *keys: int) -> np.random.Generator:
    """The generator of one part of one input. Any whole seed works."""
    return np.random.default_rng([int(seed) % (1 << 64), *keys])


def _assemble(variants: list[bytes], ids: np.ndarray) -> np.ndarray:
    """The concatenation of ``variants[i]`` for i in ``ids``, as uint8."""
    buf = np.frombuffer(b"".join(variants), dtype=np.uint8)
    lens = np.array([len(v) for v in variants], dtype=np.int64)
    starts = np.cumsum(lens) - lens
    tl = lens[ids]
    out_off = np.cumsum(tl) - tl
    pos = np.repeat(starts[ids] - out_off, tl) + np.arange(int(tl.sum()), dtype=np.int64)
    return buf[pos]


# English tokens: word x capitalised x (no mark, ",", ";") x (no end, ".", ".\n\n"),
# each followed by a space.
_EN_VARIANTS = [
    (w.capitalize() if cap else w) + mark + end + " "
    for w in _WORDS for cap in (0, 1) for mark in ("", ",", ";") for end in ("", ".", ".\n\n")
]
_EN_VARIANTS = [v.encode("ascii") for v in _EN_VARIANTS]


def _sampler(p: np.ndarray) -> np.ndarray:
    """A table of 2^16 values in which value i fills a share p[i]: an index
    drawn uniformly from it draws i at p[i] to within 2^-16."""
    counts = np.floor(np.asarray(p) / np.sum(p) * (1 << 16)).astype(np.int64)
    counts[np.argmax(counts)] += (1 << 16) - counts.sum()
    return np.repeat(np.arange(len(counts)), counts)


def _draw(table: np.ndarray, size: int, g: np.random.Generator) -> np.ndarray:
    return table[g.integers(0, 1 << 16, size=size)]


_ZIPF = _sampler(1.0 / np.arange(1, len(_WORDS) + 1))


def english_text(n: int, g: np.random.Generator) -> np.ndarray:
    """Zipf-weighted common words in sentences of 5 or more words: a word
    takes "," or ";" at 8% (60:40), a sentence ends after its fifth word at
    18% a word, and a paragraph after a sentence at 15%."""
    parts, size = [np.zeros(0, np.uint8)], 0
    while size < n:
        m = max(n - size, 64) // 4 + 64
        words = _draw(_ZIPF, m, g)
        sent = 4 + g.geometric(0.18, size=m // 4 + 2)
        end = np.zeros(m, dtype=bool)
        ends = np.cumsum(sent) - 1
        end[ends[ends < m]] = True
        cap = np.concatenate([[True], end[:-1]])
        r = g.random(m)
        mark = np.where(r < 0.08, np.where(g.random(m) < 0.6, 1, 2), 0)
        endk = np.where(end, np.where(g.random(m) < 0.15, 2, 1), 0)
        ids = ((words * 2 + cap) * 3 + mark) * 3 + endk
        parts.append(_assemble(_EN_VARIANTS, ids))
        size += parts[-1].size
    return np.concatenate(parts)[:n]


def html(n: int, g: np.random.Generator) -> np.ndarray:
    """Markup around English: one tag of ten with one of ten classes around
    20-119 bytes of text, a fragment a line."""
    head = b"<html><head><title>corpus</title></head><body>\n"
    k = n // 80 + 8
    body_lens = g.integers(20, 120, size=k)
    text = english_text(int(body_lens.sum()), g).tobytes().decode("ascii")
    tags = g.integers(len(_TAGS), size=k).tolist()
    cls = g.integers(10, size=k).tolist()
    offs = np.concatenate([[0], np.cumsum(body_lens)]).tolist()
    frags = [f'<{_TAGS[t]} class="c{c}">{text[a:b]}</{_TAGS[t]}>\n'
             for t, c, a, b in zip(tags, cls, offs[:-1], offs[1:])]
    out = head + "".join(frags).encode("ascii")
    while len(out) < n:  # rare: the draw ran short
        out += out
    return np.frombuffer(out[:n], dtype=np.uint8)


def c_source(n: int, g: np.random.Generator) -> np.ndarray:
    """C functions of 3-8 statements over keywords, identifiers, operators
    and indentation."""
    parts, size = [b"#include <stdint.h>\n\n"], 0
    while size < n:
        k = n // 300 + 8
        nlines = g.integers(3, 9, size=k)
        m = int(nlines.sum())
        kw, var, op, val, sh = (g.integers(len(_KEYWORDS), size=m).tolist(),
                                g.integers(32, size=m).tolist(), g.integers(7, size=m).tolist(),
                                g.integers(256, size=m).tolist(), g.integers(1, 31, size=m).tolist())
        lines = [f"    {_KEYWORDS[a]} v{b} = (x {'+-*&|^%'[c]} {d}u) >> {e};\n"
                 for a, b, c, d, e in zip(kw, var, op, val, sh)]
        fns = g.integers(1000, size=k).tolist()
        ends = np.cumsum(nlines).tolist()
        start, blocks = 0, []
        for fn, end in zip(fns, ends):
            blocks.append(f"static int fn_{fn}(uint32_t x, uint32_t y) {{\n"
                          + "".join(lines[start:end]) + "    return (int)(x ^ y);\n}\n\n")
            start = end
        parts.append("".join(blocks).encode("ascii"))
        size += len(parts[-1])
    return np.frombuffer(b"".join(parts)[:n], dtype=np.uint8)


def csv_numeric(n: int, g: np.random.Generator) -> np.ndarray:
    """Rows of eight integers below 10^6, comma-separated."""
    parts, size = [], 0
    while size < n:
        rows = n // 48 + 8
        nums = list(map(str, g.integers(0, 10**6, size=8 * rows).tolist()))
        text = "\n".join(",".join(nums[i:i + 8]) for i in range(0, len(nums), 8)) + "\n"
        parts.append(text.encode("ascii"))
        size += len(parts[-1])
    return np.frombuffer(b"".join(parts)[:n], dtype=np.uint8)


def executable(n: int, g: np.random.Generator) -> np.ndarray:
    """Opcode-like bytes (12 hot bytes 55%, byte 0 20% more, the rest 25%)
    in runs of 64-1023, with zero runs of 16-511 at 15% of the runs."""
    hot = g.integers(0, 256, size=12)
    probs = np.full(256, 0.25 / 244)
    probs[hot] = 0.55 / 12
    probs[0] += 0.20
    k = n // 400 + 16
    zero = g.random(k) < 0.15
    lens = np.where(zero, g.integers(16, 512, size=k), g.integers(64, 1024, size=k))
    while lens.sum() < n:
        lens = np.concatenate([lens, lens])
        zero = np.concatenate([zero, zero])
    data = _draw(_sampler(probs).astype(np.uint8), int(lens.sum()), g)
    data[np.repeat(zero, lens)] = 0
    return data[:n]


def fax_bilevel(n: int, g: np.random.Generator) -> np.ndarray:
    """Alternating 0x00 runs (mean 900) and 0xFF runs (mean 180), each
    followed by a random ragged byte at 30%."""
    k = n // 270 + 16
    black = (np.arange(k) % 2).astype(bool)
    runs = np.where(black, g.geometric(1 / 180, size=k), g.geometric(1 / 900, size=k))
    rag = (g.random(k) < 0.3).astype(np.int64)
    ragv = g.integers(0, 256, size=k)
    lens = np.stack([runs, rag], axis=1).reshape(-1)
    vals = np.stack([np.where(black, 0xFF, 0x00), ragv], axis=1).reshape(-1)
    out = np.repeat(vals.astype(np.uint8), lens)
    while out.size < n:
        out = np.concatenate([out, out])
    return out[:n]


CLASSES = (english_text, html, c_source, csv_numeric, executable, fax_bilevel)


def canterbury_like(n: int, seed: int, index: int) -> np.ndarray:
    """``n`` bytes: equal slices of the six classes, concatenated."""
    per = -(-n // len(CLASSES))
    return np.concatenate([gen(per, rng(seed, index, i)) for i, gen in enumerate(CLASSES)])[:n]


def hpack_stream(n: int, seed: int, index: int) -> np.ndarray:
    """``n`` bytes of header names and values, back to back."""
    out, size, k = [], 0, 0
    while size < n:
        fields = header_fields(max(n // 20, 16), seed, index * 1000 + k)
        out.append(b"".join(fields))
        size += len(out[-1])
        k += 1
    return np.frombuffer(b"".join(out)[:n], dtype=np.uint8)


def header_fields(count: int, seed: int, index: int = 0) -> list[bytes]:
    """``count`` strings: the name and the value of ``count // 2`` headers,
    in order. A value is one of ten common values (40%), else a decimal
    number below 10^9 or 4-23 lowercase letters (30% each)."""
    g = rng(seed, index, 0)
    h = -(-count // 2)
    name = g.integers(len(_HEADER_NAMES), size=h).tolist()
    r1, r2 = g.random(h).tolist(), g.random(h).tolist()
    word = g.integers(len(_HEADER_WORDS), size=h).tolist()
    num = g.integers(10**9, size=h).tolist()
    nlet = g.integers(4, 24, size=h)
    letters = g.integers(97, 123, size=int(nlet.sum()), dtype=np.uint8).tobytes()
    offs = np.concatenate([[0], np.cumsum(nlet)]).tolist()
    out = []
    for i in range(h):
        if r1[i] < 0.4:
            val = _HEADER_WORDS[word[i]]
        elif r2[i] < 0.5:
            val = str(num[i]).encode()
        else:
            val = letters[offs[i]:offs[i + 1]]
        out += [_HEADER_NAMES[name[i]], val]
    return out[:count]


DATA = {"canterbury_like": canterbury_like, "hpack_stream": hpack_stream}
FIELDS = {"hpack_stream": header_fields}


class Inputs(NamedTuple):
    """A configuration's generators: ``make(n, seed, index)`` and, where it
    has strings, ``fields(count, seed, index=0)``."""

    make: Callable
    fields: Callable | None


def inputs(cfg: dict) -> Inputs:
    """The generators that ``cfg["data"]`` names: ``DATA``'s and
    ``FIELDS``'s own functions, or the file's with ``cfg`` bound."""
    name = cfg["data"]
    found = named.find("data", name, DATA, "gen.DATA", INPUTS)
    if name in DATA:
        return Inputs(found, FIELDS.get(name))
    if not callable(getattr(found, "make", None)):
        raise ValueError(f"{found.__file__} defines no make(n, seed, index, cfg)")

    def make(n: int, seed: int, index: int) -> np.ndarray:
        return found.make(n, seed, index, cfg)

    fields = None
    if callable(getattr(found, "fields", None)):
        def fields(count: int, seed: int, index: int = 0) -> list[bytes]:
            return found.fields(count, seed, index, cfg)

    return Inputs(make, fields)
