"""Writes ``s1s2_torch/viz/_glyphs.py``, the glyph atlas that
:func:`s1s2_torch.viz.render.draw_title` draws panel titles from:

    python -m s1s2_torch.viz.make_glyphs [--out PATH]

The atlas is taken from Pillow's default font (``ImageFont.load_default()``:
FreeType's rendering of Aileron Regular at size 10), the font the JAX
package's ``save_panel`` draws its titles in. For each printable ASCII
character it records the antialiased 8-bit coverage, the bearings of the
coverage box from the pen position at the top of the line, and the advance
in 26.6 fixed point; and the kerning of every pair whose advance differs
from the sum of its glyphs' advances.

This is the one module of the port that imports PIL, and only inside
:func:`atlas_source`; nothing imports it.
"""

from __future__ import annotations

import argparse
import os

FIRST, LAST = 32, 126  # printable ASCII
FONT_LICENSE = "CC0 1.0 (public-domain dedication), https://dotcolon.net/fonts/aileron"


def atlas_source() -> str:
    """The text of ``_glyphs.py`` for the installed Pillow."""
    import numpy as np
    import PIL
    from PIL import ImageFont, features

    font = ImageFont.load_default()
    family, style = font.getname()
    chars = [chr(c) for c in range(FIRST, LAST + 1)]
    adv = {c: round(font.getlength(c) * 64) for c in chars}
    lines = [
        '"""Glyph atlas of Pillow\'s default font, written by',
        "``python -m s1s2_torch.viz.make_glyphs``; do not edit.",
        "",
        f"Font: {family} {style}, size {font.size};",
        f"licence: {FONT_LICENSE}.",
        f"Rendered by Pillow {PIL.__version__} with FreeType "
        f"{features.version('freetype2')} (raqm layout "
        f"{'present' if features.check('raqm') else 'absent'}).",
        "",
        "``GLYPHS[code] = (left, top, width, height, advance, coverage)``: the",
        "coverage box's offset from the pen position at the top of the line",
        "(pixels), its size, the advance in 26.6 fixed point, and the box's",
        "8-bit coverage as hex, row by row. ``KERNING[(left, right)]`` is the",
        "26.6 adjustment of a pair's advance (absent: 0).",
        '"""',
        "",
        f"FONT = {f'{family} {style}'!r}",
        f"SIZE = {font.size!r}",
        f"PILLOW = {PIL.__version__!r}",
        f"FREETYPE = {features.version('freetype2')!r}",
        "",
        "GLYPHS = {",
    ]
    for c in chars:
        mask, (left, top) = font.getmask2(c, "L")
        w, h = mask.size
        cov = np.asarray(mask, np.uint8).reshape(h, w) if w * h else np.zeros((h, w), np.uint8)
        lines.append(f"    {ord(c)}: ({left}, {top}, {w}, {h}, {adv[c]}, "
                     f"{cov.tobytes().hex()!r}),  # {c!r}")
    lines.append("}")
    kern = {}
    for a in chars:
        for b in chars:
            k = round(font.getlength(a + b) * 64) - adv[a] - adv[b]
            if k:
                kern[ord(a), ord(b)] = k
    lines.append(f"KERNING = {kern!r}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("s1s2_torch.viz.make_glyphs")
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "_glyphs.py"))
    args = ap.parse_args(argv)
    with open(args.out, "w") as f:
        f.write(atlas_source())
    print(args.out)


if __name__ == "__main__":
    main()
