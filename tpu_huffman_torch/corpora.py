"""Deterministic benchmark corpora (a copy of ``tpu_huffman/corpora.py``).

Generators of Canterbury-shaped bytes, one per Canterbury category, each
seeded with ``numpy.random.default_rng(seed)``: the same ``(n, seed)``
gives the same bytes as the JAX package's generator, so benchmark inputs
reproduce bit for bit from the repository alone. No external text is
embedded. Each mimics the statistical shape of its category (symbol
distribution, run structure, alphabet size), which is what a static
Huffman codec is sensitive to. numpy only; kept as a copy because
importing the JAX package's module loads JAX.

Categories (Canterbury analog in parens):
  english_text   (alice29.txt / plrabn12.txt) — word-frequency English
  html           (cp.html)                    — markup + text
  c_source       (fields.c)                   — code: keywords, symbols
  csv_numeric    (kennedy.xls numeric grid)   — digits, separators
  executable     (sum, SPARC binary)          — opcode-like + zero runs
  fax_bilevel    (ptt5, CCITT fax)            — long 0x00/0xFF runs
"""

from __future__ import annotations

import numpy as np

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


def english_text(n: int, seed: int = 0) -> bytes:
    """Word-frequency English: Zipf-weighted common words, sentence and
    paragraph structure (Canterbury analog: alice29.txt)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, len(_WORDS) + 1)  # Zipf over the word list
    w /= w.sum()
    out = []
    size = 0
    sentence = 0
    while size < n + 64:  # slack: the size estimate overcounts separators
        word = _WORDS[rng.choice(len(_WORDS), p=w)]
        if sentence == 0:
            word = word.capitalize()
        out.append(word)
        size += len(word) + 1
        sentence += 1
        if rng.random() < 0.08:
            out[-1] += "," if rng.random() < 0.6 else ";"
            size += 1
        if sentence > 4 and rng.random() < 0.18:
            out[-1] += "."
            sentence = 0
            size += 1
            if rng.random() < 0.15:
                out[-1] += "\n\n"
                size += 2
    return " ".join(out).encode("ascii")[:n]


def html(n: int, seed: int = 1) -> bytes:
    """Markup-heavy text (Canterbury analog: cp.html)."""
    rng = np.random.default_rng(seed)
    tags = ["p", "a", "li", "td", "tr", "h2", "em", "div", "span", "code"]
    out = ["<html><head><title>corpus</title></head><body>\n"]
    size = len(out[0])
    while size < n:
        t = tags[int(rng.integers(len(tags)))]
        body = english_text(int(rng.integers(20, 120)), int(rng.integers(1 << 30))).decode("ascii")
        frag = f"<{t} class=\"c{int(rng.integers(10))}\">{body}</{t}>\n"
        out.append(frag)
        size += len(frag)
    return "".join(out).encode("ascii")[:n]


def c_source(n: int, seed: int = 2) -> bytes:
    """Code-shaped bytes: keywords, identifiers, operators, indentation
    (Canterbury analog: fields.c)."""
    rng = np.random.default_rng(seed)
    out = ["#include <stdint.h>\n\n"]
    size = len(out[0])
    while size < n:
        fn = f"fn_{int(rng.integers(1000))}"
        lines = [f"static int {fn}(uint32_t x, uint32_t y) {{\n"]
        for _ in range(int(rng.integers(3, 9))):
            k = _KEYWORDS[int(rng.integers(len(_KEYWORDS)))]
            v = int(rng.integers(256))
            op = "+-*&|^%"[int(rng.integers(7))]
            lines.append(f"    {k} v{int(rng.integers(32))} = (x {op} {v}u) >> {int(rng.integers(1, 31))};\n")
        lines.append("    return (int)(x ^ y);\n}\n\n")
        frag = "".join(lines)
        out.append(frag)
        size += len(frag)
    return "".join(out).encode("ascii")[:n]


def csv_numeric(n: int, seed: int = 3) -> bytes:
    """Digit/separator grid (Canterbury analog: kennedy.xls content)."""
    rng = np.random.default_rng(seed)
    rows = []
    size = 0
    while size < n:
        row = ",".join(str(int(v)) for v in rng.integers(0, 10**6, size=8))
        rows.append(row)
        size += len(row) + 1
    return "\n".join(rows).encode("ascii")[:n]


def executable(n: int, seed: int = 4) -> bytes:
    """Binary with opcode-like clustering and zero-padding runs
    (Canterbury analog: sum, a SPARC executable)."""
    rng = np.random.default_rng(seed)
    parts = []
    size = 0
    # opcode-ish alphabet: a few hot bytes, a warm middle, a cold tail
    hot = rng.integers(0, 256, size=12)
    probs = np.full(256, 0.25 / 244)
    probs[hot] = 0.55 / 12
    probs[0] += 0.20
    probs /= probs.sum()
    while size < n:
        if rng.random() < 0.15:
            run = int(rng.integers(16, 512))
            parts.append(np.zeros(run, np.uint8))
        else:
            run = int(rng.integers(64, 1024))
            parts.append(rng.choice(256, size=run, p=probs).astype(np.uint8))
        size += run
    return np.concatenate(parts).tobytes()[:n]


def fax_bilevel(n: int, seed: int = 5) -> bytes:
    """Long alternating 0x00/0xFF runs with ragged edges (Canterbury
    analog: ptt5, CCITT fax test image)."""
    rng = np.random.default_rng(seed)
    parts = []
    size = 0
    black = False
    while size < n:
        run = int(rng.geometric(1 / 180)) if black else int(rng.geometric(1 / 900))
        fill = 0xFF if black else 0x00
        parts.append(np.full(min(run, n - size), fill, np.uint8))
        size += parts[-1].size
        if rng.random() < 0.3:  # ragged boundary byte
            parts.append(np.array([int(rng.integers(256))], np.uint8))
            size += 1
        black = not black
    return np.concatenate(parts).tobytes()[:n]


CATEGORIES = {
    "english_text": english_text,
    "html": html,
    "c_source": c_source,
    "csv_numeric": csv_numeric,
    "executable": executable,
    "fax_bilevel": fax_bilevel,
}


def canterbury_like(n: int, seed: int = 0) -> bytes:
    """A mixed stream: equal-size slices of every category, concatenated —
    the single-corpus form of BASELINE config 2."""
    per = -(-n // len(CATEGORIES))
    blobs = [
        gen(per, seed + i) for i, gen in enumerate(CATEGORIES.values())
    ]
    return b"".join(blobs)[:n]
