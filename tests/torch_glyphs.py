"""Generator of the PyTorch port's glyph atlas
(wisecondorx_tpu_torch/output/_glyphs.py).

The port writes its PNG figures without matplotlib, so the glyphs of its
labels are rendered once here, from the DejaVu Sans font that ships with
matplotlib, and committed as data.  Each glyph is rendered the way
matplotlib's Agg backend renders text (``FT2Font`` with its hinting
factor and hinting flags, antialiased), trimmed to its ink, and stored with
its bearings and its unhinted advance, at every (font size, dpi) pair the
figures use.

    python tests/torch_glyphs.py      # rewrites the atlas module

tests/test_torch_plots.py regenerates the atlas and holds it equal to the
committed one.
"""

import base64
import os
import struct
import zlib

#: (points, dpi) pairs: tick labels (7, 8 and 10 pt), axis labels (10 pt)
#: and titles (12 pt) on the genome-wide (160 dpi), chromosome (120 dpi)
#: and --plotyfrac (100 dpi) figures; 7 pt is also the subscript of the
#: 10 pt ylabel.
SIZES = tuple((pt, dpi) for dpi in (160, 120, 100) for pt in (7, 8, 10, 12))
#: Printable ASCII and U+2212, the minus sign of matplotlib's tick labels.
CHARS = "".join(chr(c) for c in range(32, 127)) + "−"
HEADER = struct.Struct("<hhhhi")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = os.path.join(REPO, "wisecondorx_tpu_torch", "output", "_glyphs.py")


def _font_paths():
    import matplotlib

    ttf = os.path.join(matplotlib.get_data_path(), "fonts", "ttf")
    return os.path.join(ttf, "DejaVuSans.ttf"), os.path.join(ttf, "LICENSE_DEJAVU")


def _glyph(font, char, flags, hinting_factor):
    """(rows, cols, bearing_x px, bearing_y px, advance in 1/64 px, bytes)
    of one character at the font's current size."""
    import numpy as np

    font.set_text(char, 0.0, flags=flags)
    font.draw_glyphs_to_bitmap(antialiased=True)
    image = np.asarray(font.get_image(), dtype=np.uint8)
    glyph = font.load_char(ord(char), flags=flags)
    advance = int(round(glyph.linearHoriAdvance / 65536 * 64))
    rows = np.nonzero(image.any(axis=1))[0]
    cols = np.nonzero(image.any(axis=0))[0]
    if not len(rows):
        return 0, 0, 0, 0, advance, b""
    ink = image[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]
    bearing_x = int(round(glyph.horiBearingX / 64 / hinting_factor))
    bearing_y = int(round(glyph.horiBearingY / 64))
    return (ink.shape[0], ink.shape[1], bearing_x, bearing_y, advance,
            np.ascontiguousarray(ink).tobytes())


def build_payload() -> bytes:
    """The atlas's bytes, before compression: for each size of SIZES and
    each character of CHARS, one HEADER then rows x cols coverage bytes."""
    import matplotlib
    from matplotlib.backends.backend_agg import get_hinting_flag
    from matplotlib.ft2font import FT2Font

    ttf, _ = _font_paths()
    factor = matplotlib.rcParams["text.hinting_factor"]
    font = FT2Font(ttf, hinting_factor=factor,
                   _kerning_factor=matplotlib.rcParams["text.kerning_factor"])
    flags = get_hinting_flag()
    out = bytearray()
    for pt, dpi in SIZES:
        font.set_size(pt, dpi)
        for char in CHARS:
            rows, cols, bx, by, adv, data = _glyph(font, char, flags, factor)
            out += HEADER.pack(rows, cols, bx, by, adv) + data
    return bytes(out)


def module_source() -> str:
    """The text of the atlas module."""
    _, licence = _font_paths()
    notice = "\n".join(
        ("# " + line).rstrip() for line in open(licence).read().splitlines()
    )
    blob = base64.b64encode(zlib.compress(build_payload(), 9)).decode()
    lines = "\n".join(f'    "{blob[i:i + 76]}"' for i in range(0, len(blob), 76))
    return (
        '"""Glyph atlas of the PNG writer: DejaVu Sans rendered at the sizes\n'
        "the figures use.  Generated by tests/torch_glyphs.py; do not edit.\n"
        '"""\n\n'
        "# The glyphs are rendered from DejaVu Sans, under this licence:\n#\n"
        f"{notice}\n\n"
        f"SIZES = {SIZES!r}\n"
        f"CHARS = {CHARS!r}\n"
        "#: zlib-compressed, base64-encoded; for each size and character a\n"
        "#: little-endian header (rows, cols, bearing_x, bearing_y: int16;\n"
        "#: advance in 1/64 px: int32) and rows x cols coverage bytes.\n"
        f"DATA = (\n{lines}\n)\n"
    )


if __name__ == "__main__":
    with open(MODULE, "w") as f:
        f.write(module_source())
    print(f"wrote {MODULE}")
