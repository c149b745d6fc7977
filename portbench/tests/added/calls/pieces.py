"""``strings`` with each string's stream fed to ``decode_chunk`` in
pieces of ``piece_bytes`` (chip_smoke.py's phase 9: 7), so that the
decoder resumes within a string."""

from __future__ import annotations

from portbench import patterns


class Pattern(patterns.Strings):
    def __init__(self, ctx: patterns.Context):
        super().__init__(ctx)
        self.piece = int(ctx.mix["piece_bytes"])

    def _decode(self, e: bytes):
        self.dec.reset()
        out = [self.dec.decode_chunk(e[a:a + self.piece]).data
               for a in range(0, max(len(e), 1), self.piece)]
        return b"".join(out), self.dec.padding_is_all_ones()
