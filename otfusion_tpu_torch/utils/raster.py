"""A small RGB canvas in numpy for the run's PNG figures.

The JAX package draws its confusion matrix and t-SNE scatter with
matplotlib, which the machine the port runs on does not have. This module
is what those two figures need and no more:

  * filled rectangles, images (a colormap's strip, a heatmap's cells),
    anti-aliased lines and discs, each composited with an alpha;
  * text in a bitmap font of the printable ASCII characters, at any pixel
    size (the glyphs are scaled with linear interpolation), horizontal or
    turned 90 degrees counter-clockwise;
  * matplotlib's ``Blues`` and ``coolwarm`` colormaps as 256-entry tables,
    built with matplotlib's rule (``LinearSegmentedColormap`` with N = 256:
    linear interpolation between control points on [0, 1]) from the control
    points of ``matplotlib/_cm.py``, and looked up as matplotlib looks them
    up (index ``floor(v * 256)``, clipped to 255);
  * the PNG through ``data/png_io.py:write_png``.

The font was rasterised from DejaVu Sans (the typeface matplotlib draws
with by default; Bitstream Vera licence) at 14 pixels, matplotlib's 10
points at 100 dpi, and is kept at 4 bits of coverage a pixel.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from otfusion_tpu_torch.data.png_io import write_png

# ColorBrewer's 9 Blues, equally spaced on [0, 1] (matplotlib's _Blues_data).
_BLUES = (
    (0.96862745098039216, 0.98431372549019602, 1.0),
    (0.87058823529411766, 0.92156862745098034, 0.96862745098039216),
    (0.77647058823529413, 0.85882352941176465, 0.93725490196078431),
    (0.61960784313725492, 0.792156862745098, 0.88235294117647056),
    (0.41960784313725491, 0.68235294117647061, 0.83921568627450982),
    (0.25882352941176473, 0.5725490196078431, 0.77647058823529413),
    (0.12941176470588237, 0.44313725490196076, 0.70980392156862748),
    (0.03137254901960784, 0.31764705882352939, 0.61176470588235299),
    (0.03137254901960784, 0.18823529411764706, 0.41960784313725491),
)

# Moreland's diverging map at x = k / 32 (matplotlib's _coolwarm_data).
_COOLWARM = (
    (0.2298057, 0.298717966, 0.753683153),
    (0.26623388, 0.353094838, 0.801466763),
    (0.30386891, 0.406535296, 0.84495867),
    (0.342804478, 0.458757618, 0.883725899),
    (0.38301334, 0.50941904, 0.917387822),
    (0.424369608, 0.558148092, 0.945619588),
    (0.46666708, 0.604562568, 0.968154911),
    (0.509635204, 0.648280772, 0.98478814),
    (0.552953156, 0.688929332, 0.995375608),
    (0.596262162, 0.726149107, 0.999836203),
    (0.639176211, 0.759599947, 0.998151185),
    (0.681291281, 0.788964712, 0.990363227),
    (0.722193294, 0.813952739, 0.976574709),
    (0.761464949, 0.834302879, 0.956945269),
    (0.798691636, 0.849786142, 0.931688648),
    (0.833466556, 0.860207984, 0.901068838),
    (0.865395197, 0.86541021, 0.865395561),
    (0.897787179, 0.848937047, 0.820880546),
    (0.924127593, 0.827384882, 0.774508472),
    (0.944468518, 0.800927443, 0.726736146),
    (0.958852946, 0.769767752, 0.678007945),
    (0.96732803, 0.734132809, 0.628751763),
    (0.969954137, 0.694266682, 0.579375448),
    (0.966811177, 0.650421156, 0.530263762),
    (0.958003065, 0.602842431, 0.481775914),
    (0.943660866, 0.551750968, 0.434243684),
    (0.923944917, 0.49730856, 0.387970225),
    (0.89904617, 0.439559467, 0.343229596),
    (0.869186849, 0.378313092, 0.300267182),
    (0.834620542, 0.312874446, 0.259301199),
    (0.795631745, 0.24128379, 0.220525627),
    (0.752534934, 0.157246067, 0.184115123),
    (0.705673158, 0.01555616, 0.150232812),
)


def _lut(points) -> np.ndarray:
    """(256, 3) table of control points equally spaced on [0, 1]."""
    points = np.asarray(points, np.float64)
    grid = np.linspace(0.0, 1.0, len(points))
    x = np.linspace(0.0, 1.0, 256)
    return np.clip(np.stack([np.interp(x, grid, points[:, c])
                             for c in range(3)], axis=1), 0.0, 1.0)


COLORMAPS = {"Blues": _lut(_BLUES), "coolwarm": _lut(_COOLWARM)}


def colormap(name: str, values) -> np.ndarray:
    """RGB in [0, 1] of ``values`` in [0, 1], as matplotlib's colormap
    ``name`` gives them (its lookup: entry ``floor(v * 256)``, clipped)."""
    index = np.clip(np.floor(np.asarray(values, np.float64) * 256), 0, 255)
    return COLORMAPS[name][index.astype(np.int64)]


def normalize(values, vmin: float, vmax: float) -> np.ndarray:
    """matplotlib's ``Normalize``: (v - vmin) / (vmax - vmin), 0 where the
    range is empty."""
    values = np.asarray(values, np.float64)
    if vmax == vmin:
        return np.zeros_like(values)
    return (values - vmin) / (vmax - vmin)

_FONT_PX = 14
_FONT_ASCENT = 13
_FONT_DESCENT = 4
# char: (advance, left, top from the baseline, width, height, 4-bit alpha
# row by row, one hex digit a pixel)
_GLYPHS = {
    ' ': (4, 0, 0, 0, 0, ""),
    '!': (6, 2, -10, 2, 10, "d8d8d8d7d7c60000d8d8"),
    '"': (6, 1, -10, 5, 4, "a81f1a81f1a81f1a81f1"),
    '#': (12, 1, -10, 10, 10,
        "0001f00e200005c03d000008807a002ffffffffa001f10e200006b04d000efffffff"
        "d000d30c500002e01f100005b04d0000"
    ),
    '$': (9, 1, -11, 7, 13,
        "000a000000a00019dfc609c2a392c70a0009d3a00018dfb60000b5e7000a09ba51a3"
        "d73aefd80000a000000a000"
    ),
    '%': (13, 0, -10, 13, 10,
        "04de70001d2000e52e300a60003e00a605c00003e00a61d300000e52e3983de7004d"
        "e73d1d52e300000c42e009700007902e00970002d100d52e3000c50004de80"
    ),
    '&': (11, 0, -10, 11, 10,
        "002aed6000000bb129100000e6000000000ab0000000009f900000009c3da006e01f"
        "401cb1a901f5001bde100ad4128fd20007dfe92ad2"
    ),
    "'": (4, 1, -10, 2, 4, "a8a8a8a8"),
    '(': (5, 1, -11, 4, 12,
        "01e209801f206d00aa00b900b900aa006d001f20099001e2"
    ),
    ')': (5, 1, -11, 4, 12,
        "98002e200b8006d003f202f302f303f206d00b802e209800"
    ),
    '*': (7, 0, -10, 7, 6, "000c000591c19504beb4004beb40591c195000c000"),
    '+': (12, 1, -9, 10, 9,
        "0000b700000000b700000000b700000000b700008ffffffff40000b700000000b700"
        "000000b700000000b70000"
    ),
    ',': (4, 1, -2, 3, 3, "5f17c0c40"),
    '-': (5, 0, -4, 5, 1, "5fff6"),
    '.': (4, 1, -2, 2, 2, "8e8e"),
    '/': (5, 0, -10, 5, 12,
        "00099000d4003e0007a000c6001f1006c000a7000e3004d00089000d5000"
    ),
    '0': (9, 0, -10, 8, 10,
        "006dfc5004f617f30ba000ca0e60008d1f50007e1f50007e0e60008d0ba000ca04f6"
        "17f3006dfc50"
    ),
    '1': (9, 1, -10, 7, 10,
        "16cf500693f500000f500000f500000f500000f500000f500000f500000f5004ffff"
        "f9"
    ),
    '2': (9, 1, -10, 7, 10,
        "3aeeb30b5119e200000f600001f50000ad10008e30008e40007e40007e40000fffff"
        "f8"
    ),
    '3': (9, 1, -10, 7, 10,
        "19dec5086216f400000d700016e303fff5000016f500000ab00000bba4117f54beeb"
        "40"
    ),
    '4': (9, 0, -10, 9, 10,
        "00006fa000003dca00001d4ba0000990ba0005d10ba002e300ba005fffffff200000"
        "ba0000000ba0000000ba00"
    ),
    '5': (9, 1, -10, 7, 10,
        "7ffffe07c000007c000007feeb306512ae200000d800000ba00000d8a412ae23beea"
        "30"
    ),
    '6': (9, 1, -10, 7, 10,
        "02aee911da21658e10000d900000f8bfd81ff513d9da0007eaa0007e3f513d904cfd"
        "80"
    ),
    '7': (9, 1, -10, 7, 10,
        "dfffffa00002f500008e00000e800005f30000ac00001f600007e10000d900004f30"
        "00"
    ),
    '8': (9, 0, -10, 8, 10,
        "018dfd8009d304e70b9000ba06d304e5008fff7008d314e60e70008d0e60008d0ad3"
        "14e8018dfd80"
    ),
    '9': (9, 0, -10, 8, 10,
        "019dfc300ad316e21f5000c81f5000cc0bc316fd019eea9d000000ab000001e70651"
        "2bc0019ee910"
    ),
    ':': (5, 1, -7, 3, 7, "5f15f10000000005f15f1"),
    ';': (5, 1, -7, 3, 8, "5f15f10000000005f17c0c40"),
    '<': (12, 1, -8, 10, 8,
        "00000005b4000028ee91016cfb61005ed82000005ed8200000016cfb5100000028ee"
        "9100000005b4"
    ),
    '=': (12, 1, -7, 10, 4, "8ffffffff4000000000000000000008ffffffff4"),
    '>': (12, 1, -8, 10, 8,
        "79300000003bfc7100000027dfa4000000039ed20000039ed20027dfa4003bfd7100"
        "007930000000"
    ),
    '?': (7, 1, -10, 6, 10,
        "4ced70b305f40000f50009d100ad2003f20004f00000000005f10005f100"
    ),
    '@': (14, 0, -10, 13, 12,
        "00006beed8100002cb41038e4001d60000003e2089019ed6e06a0d208b22be01e0e0"
        "0c4004e00f0e00c4004e03c0d208b21be3d4089019ed7eb3001d6000000000002da4"
        "1139a0000017ceec9300"
    ),
    'A': (10, 0, -10, 10, 10,
        "0003fc00000009cf2000001e4b8000005d05e00000b700e50002f2008b0008ffffff"
        "200e50000b705f100007d0ab000002f4"
    ),
    'B': (10, 1, -10, 8, 10,
        "9fffeb309b001ae09b0004f29b001ad09ffffe309b0017e29b0000e89b0000e89b00"
        "17f39fffec50"
    ),
    'C': (10, 0, -10, 10, 10,
        "0018dfdb4002db3014b00ad00000001f700000003f500000003f500000001f700000"
        "000ad000000002db3014b00018dfdb40"
    ),
    'D': (11, 1, -10, 9, 10,
        "9fffeb6009b0015db09b00002f79b00000ac9b000008e9b000008e9b00000ac9b000"
        "02f79b0015dc19fffeb600"
    ),
    'E': (9, 1, -10, 7, 10,
        "9fffffc9b000009b000009b000009fffff99b000009b000009b000009b000009ffff"
        "fe"
    ),
    'F': (8, 1, -10, 7, 10,
        "9fffff49b000009b000009b000009ffffc09b000009b000009b000009b000009b000"
        "00"
    ),
    'G': (11, 0, -10, 10, 10,
        "0018dfec6102db4113960ad00000001f700000003f500000003f5000effb1f700000"
        "ab0ad00000ab02dc4113cb0018dfec81"
    ),
    'H': (11, 1, -10, 9, 10,
        "9b00004f29b00004f29b00004f29b00004f29fffffff29b00004f29b00004f29b000"
        "04f29b00004f29b00004f2"
    ),
    'I': (4, 1, -10, 2, 10, "9b9b9b9b9b9b9b9b9b9b"),
    'J': (4, -1, -10, 4, 13,
        "009b009b009b009b009b009b009b009b009b009b00ba03e6be80"
    ),
    'K': (9, 1, -10, 9, 10,
        "9b0004e809b005f7009b06f60009b7f500009ff5000009cdc100009b1cc10009b01c"
        "d1009b001cd109b0001cd2"
    ),
    'L': (8, 1, -10, 7, 10,
        "9b000009b000009b000009b000009b000009b000009b000009b000009b000009ffff"
        "fb"
    ),
    'M': (12, 1, -10, 10, 10,
        "9f900008fb9de1000edb9bc6005dab9b6c00b7ab9b1e32f1ab9b0987a0ab9b04ed50"
        "ab9b00de00ab9b000000ab9b000000ab"
    ),
    'N': (10, 1, -10, 9, 10,
        "9f80004f19fe1004f19bc9004f19b4f204f19b0ba04f19b03f34f19b00ab4f19b002"
        "f8f19b0009ff19b0001ef1"
    ),
    'O': (11, 0, -10, 11, 10,
        "0029dfd920002eb302be200ad00000da01f7000007f13f5000004f33f5000004f31f"
        "7000007f10ad00000da002eb302ae200029dfe9200"
    ),
    'P': (8, 1, -10, 7, 10,
        "9fffd819b004e99b0009d9b0009d9b004e99fffd819b000009b000009b000009b000"
        "00"
    ),
    'Q': (11, 0, -10, 11, 12,
        "0029dfd920002eb302be200ad00000da01f7000007f13f5000004f33f5000004f31f"
        "7000007f10ad00000da002eb302ae200029dffc1000000008e2000000000cd10"
    ),
    'R': (10, 1, -10, 9, 10,
        "9fffd81009b004e9009b0008d009b0008e009b003e8009ffffa0009b005f5009b000"
        "8e109b0001e809b00006e1"
    ),
    'S': (9, 0, -10, 9, 10,
        "018dec7100ac3127700f60000000e900000005eea720000159df600000009e000000"
        "06f10b5213db004aded810"
    ),
    'T': (9, -1, -10, 10, 10,
        "1ffffffff900006f000000006f000000006f000000006f000000006f000000006f00"
        "0000006f000000006f000000006f0000"
    ),
    'U': (10, 1, -10, 9, 10,
        "c900005f0c900005f0c900005f0c900005f0c900005f0c900005f0ba00006f09d000"
        "09c02f8115e6003beec500"
    ),
    'V': (10, 0, -10, 10, 10,
        "bb000002f45f200008d00e80000e7008d0005f2002f400bb0000ba02f500005f17e0"
        "00001e6d80000009ef20000003fc0000"
    ),
    'W': (14, 0, -10, 14, 10,
        "6e0000ec0002f42f4004ef1006f00d7007ac500ab00ab00b68900e7006f00f24d02f"
        "4002f44d01f16e0000d88a00c5ab00009bb60089e700006ff2004ef300002fd0001f"
        "e000"
    ),
    'X': (10, 0, -10, 10, 10,
        "0ca0001d9002e6009d10006e25f300000bbe70000002fc00000006fe2000002e6bc0"
        "0000ca01e70008d1005f204f40000ac0"
    ),
    'Y': (9, 0, -10, 9, 10,
        "ac00004f41e7001d8005f309c00009c5f300001df70000007f00000006f00000006f"
        "00000006f00000006f0000"
    ),
    'Z': (10, 0, -10, 9, 10,
        "3fffffffc0000005f7000003ea000001dc000000be2000009f3000006f6000003f90"
        "00002eb0000006ffffffff"
    ),
    '[': (5, 1, -11, 4, 12,
        "cff2c700c700c700c700c700c700c700c700c700c700cff2"
    ),
    '\\': (5, 0, -10, 5, 12,
        "d5000890004d0000e3000a70006c0001f1000c60007a0003e0000d400099"
    ),
    ']': (5, 1, -11, 4, 12,
        "aff400f400f400f400f400f400f400f400f400f400f4aff4"
    ),
    '^': (12, 1, -10, 10, 4, "0004fd2000003e8bd10003e700ac102e60000ab0"),
    '_': (7, -1, 2, 9, 1, "2fffffff2"),
    '`': (7, 1, -11, 4, 3, "7c000b7001d2"),
    'a': (9, 0, -8, 8, 8,
        "09ffeb20000019d0000000f303aefff40d9200f52f2003f50e813cf504dfd7e5"
    ),
    'b': (9, 1, -11, 8, 11,
        "b8000000b8000000b8000000b9aee800bf714e70bc0007d0b90004f1b90004f1bc00"
        "07d0bf714e70b9aee800"
    ),
    'c': (8, 0, -8, 7, 8,
        "007dfc408e51391e600003f200003f200001e6000008e5139007dfc4"
    ),
    'd': (9, 0, -11, 8, 11,
        "000000a9000000a9000000a9009ed9a908d318f91f5000d93f2000b93f2000b91f50"
        "00d908d318f9019ee9a9"
    ),
    'e': (9, 0, -8, 8, 8,
        "007dfd6007d314e50e40007b3ffffffd3f2000001e70000008e51267006dfd91"
    ),
    'f': (5, 0, -11, 6, 11,
        "009ef305e20007c000afffd007c00007c00007c00007c00007c00007c00007c000"
    ),
    'g': (9, 0, -8, 8, 11,
        "019ed9a909d318f91f5000d93f2000a93f2000b91f5000d909d318f9019ee9b90000"
        "00d7046118e2019deb30"
    ),
    'h': (9, 1, -11, 7, 11,
        "b800000b800000b800000b9aee90bf613e6ba000a9b80009ab80009ab80009ab8000"
        "9ab80009a"
    ),
    'i': (4, 1, -11, 2, 11, "a9a900a9a9a9a9a9a9a9a9"),
    'j': (4, -1, -11, 4, 14,
        "00a900a9000000a900a900a900a900a900a900a900a900b801d64ea0"
    ),
    'k': (8, 1, -11, 7, 11,
        "b800000b800000b800000b8004e5b805e40b87e400bdf3000bae9000b82e800b802e"
        "80b8002e8"
    ),
    'l': (4, 1, -11, 2, 11, "a9a9a9a9a9a9a9a9a9a9a9"),
    'm': (14, 1, -8, 12, 8,
        "baaee82aed60bf514fe515f2ba000ca000d6b8000c8000c7b8000c8000c7b8000c80"
        "00c7b8000c8000c7b8000c8000c7"
    ),
    'n': (9, 1, -8, 7, 8,
        "b9aee90bf613e6ba000a9b80009ab80009ab80009ab80009ab80009a"
    ),
    'o': (9, 0, -8, 8, 8,
        "008efc4008d318f20f5000c82f20009b3f20009b0f5000c808d317f2008efc40"
    ),
    'p': (9, 1, -8, 8, 11,
        "b9aee800bf714e70bc0007d0b90004f1b90004f1bc0007d0bf714e70b9aee800b800"
        "0000b8000000b8000000"
    ),
    'q': (9, 0, -8, 8, 11,
        "009ed9a908d318f91f5000d93f2000b93f2000b91f5000d908d318f9019ee9a90000"
        "00a9000000a9000000a9"
    ),
    'r': (6, 1, -8, 5, 8, "b9aebbf610bb000b8000b8000b8000b8000b8000"),
    's': (7, 0, -8, 7, 8,
        "04ced701e612832f200000bd84100048cd200000c839303e606ced80"
    ),
    't': (5, 0, -10, 6, 10,
        "0b80000b80009ffff20b80000b80000b80000b80000a900008b10002cef2"
    ),
    'u': (9, 1, -8, 7, 8,
        "c7000a9c7000a9c7000a9c7000a9c7000a9b8000c98d217f91aed9a9"
    ),
    'v': (8, 0, -8, 8, 8,
        "6e0000aa1f4001e50aa005e005e10b9000e51f40009b6d00004fd800000df300"
    ),
    'w': (11, 0, -8, 11, 8,
        "4e002f9008b1f306ed00c70c70a7f11f308b0d3b54e004e2e0898b001f9b04dc7000"
        "cf700ff30008f300be00"
    ),
    'x': (8, 0, -8, 8, 8,
        "1e7003f504f31d90008d9d10000df300002ef50000ca7e2008d10bb04f4001e7"
    ),
    'y': (8, 0, -8, 8, 11,
        "6e0000aa1e5001f409b006e003f10c8000c73f20006d9b00001ff600000ae100000b"
        "9000004f30000de70000"
    ),
    'z': (7, 0, -8, 7, 8,
        "4fffffb00002e70001da0000ac10008e20005f40003e600006fffffb"
    ),
    '{': (9, 1, -11, 7, 13,
        "0007df2001f600002f200002f200002f200018e0004ff5000018e000003f200002f2"
        "00002f200000f6000006df2"
    ),
    '|': (5, 1, -11, 2, 14, "3e3e3e3e3e3e3e3e3e3e3e3e3e3e"),
    '}': (9, 1, -11, 7, 13,
        "4fd6000008e000004f000004f000003f100001f7000006ff2001f710003f100004f0"
        "00004f000008d0004fd5000"
    ),
    '~': (12, 1, -6, 10, 4, "000000000019dea5129476116ced700000000000"),
}


def _glyph(ch: str):
    adv, left, top, w, h, bits = _GLYPHS.get(ch, _GLYPHS["?"])
    mask = (np.frombuffer(bits.encode(), np.uint8).astype(np.int64)
            if bits else np.zeros(0, np.int64))
    # hex digits: '0'-'9' are 48-57, 'a'-'f' are 97-102
    mask = np.where(mask >= 97, mask - 87, mask - 48).astype(np.float32)
    return adv, left, top, mask.reshape(h, w) / 15.0


def _resize(mask: np.ndarray, shape) -> np.ndarray:
    """Linear interpolation of a 2-D mask to ``shape`` (half-pixel
    centres)."""
    out = mask
    for axis, new in enumerate(shape):
        old = out.shape[axis]
        if old == new:
            continue
        pos = np.clip((np.arange(new) + 0.5) * old / new - 0.5, 0, old - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, old - 1)
        w = (pos - lo).reshape((-1, 1) if axis == 0 else (1, -1))
        out = (np.take(out, lo, axis=axis) * (1 - w)
               + np.take(out, hi, axis=axis) * w)
    return out


def text_mask(text: str, size: float = _FONT_PX) -> np.ndarray:
    """Coverage (H, W) in [0, 1] of ``text`` set at ``size`` pixels; the
    box runs from the font's ascent above the baseline to its descent
    below."""
    scale = size / _FONT_PX
    width = sum(_glyph(ch)[0] for ch in text) + 2
    mask = np.zeros((_FONT_ASCENT + _FONT_DESCENT, width), np.float32)
    pen = 1
    for ch in text:
        adv, left, top, glyph = _glyph(ch)
        h, w = glyph.shape
        y0, x0 = _FONT_ASCENT + top, pen + left
        if h and w:
            region = mask[y0:y0 + h, x0:x0 + w]
            np.maximum(region, glyph[:region.shape[0], :region.shape[1]],
                       out=region)
        pen += adv
    if scale == 1.0:
        return mask
    return np.clip(_resize(mask, (max(1, round(mask.shape[0] * scale)),
                                  max(1, round(mask.shape[1] * scale)))),
                   0.0, 1.0)


class Canvas:
    """An RGB image of ``width`` x ``height`` pixels, in [0, 1] floats;
    pixel (x, y) covers [x, x + 1) x [y, y + 1), y down."""

    def __init__(self, width: int, height: int, background=(1.0, 1.0, 1.0)):
        self.pixels = np.empty((height, width, 3), np.float64)
        self.pixels[:] = background

    def blend(self, x0: int, y0: int, coverage: np.ndarray, colour) -> None:
        """Composite ``colour`` over the canvas at ``coverage`` (H, W), the
        alpha of each pixel, with its top-left pixel at (x0, y0)."""
        h, w = coverage.shape
        ch, cw = self.pixels.shape[:2]
        ya, yb = max(0, y0), min(ch, y0 + h)
        xa, xb = max(0, x0), min(cw, x0 + w)
        if ya >= yb or xa >= xb:
            return
        a = coverage[ya - y0:yb - y0, xa - x0:xb - x0, None]
        region = self.pixels[ya:yb, xa:xb]
        region *= 1.0 - a
        region += a * np.asarray(colour, np.float64)

    def rect(self, x0, y0, x1, y1, colour, alpha: float = 1.0) -> None:
        """Fill the pixels [x0, x1) x [y0, y1) (rounded)."""
        x0, y0, x1, y1 = (int(round(v)) for v in (x0, y0, x1, y1))
        if x1 > x0 and y1 > y0:
            self.blend(x0, y0, np.full((y1 - y0, x1 - x0), alpha), colour)

    def image(self, x0: int, y0: int, rgb: np.ndarray) -> None:
        """Paste an (H, W, 3) RGB array with its top-left pixel at
        (x0, y0)."""
        h, w = rgb.shape[:2]
        self.pixels[y0:y0 + h, x0:x0 + w] = rgb

    def line(self, x0, y0, x1, y1, colour, width: float = 1.0) -> None:
        """An anti-aliased segment from (x0, y0) to (x1, y1)."""
        pad = width / 2 + 1
        xa, ya = int(np.floor(min(x0, x1) - pad)), int(np.floor(min(y0, y1)
                                                                 - pad))
        xb, yb = int(np.ceil(max(x0, x1) + pad)), int(np.ceil(max(y0, y1)
                                                               + pad))
        px = np.arange(xa, xb) + 0.5
        py = (np.arange(ya, yb) + 0.5)[:, None]
        dx, dy = x1 - x0, y1 - y0
        t = np.clip(((px - x0) * dx + (py - y0) * dy)
                    / max(dx * dx + dy * dy, 1e-12), 0.0, 1.0)
        dist = np.hypot(px - (x0 + t * dx), py - (y0 + t * dy))
        self.blend(xa, ya, np.clip(width / 2 + 0.5 - dist, 0.0, 1.0), colour)

    def disc(self, cx, cy, radius, colour, alpha: float = 1.0) -> None:
        """An anti-aliased filled disc centred on (cx, cy)."""
        xa, ya = int(np.floor(cx - radius - 1)), int(np.floor(cy - radius - 1))
        n = int(np.ceil(2 * radius + 3))
        px = np.arange(xa, xa + n) + 0.5
        py = (np.arange(ya, ya + n) + 0.5)[:, None]
        dist = np.hypot(px - cx, py - cy)
        self.blend(xa, ya, alpha * np.clip(radius + 0.5 - dist, 0.0, 1.0),
                   colour)

    def text(self, x, y, text: str, colour=(0.0, 0.0, 0.0),
             size: float = _FONT_PX, ha: str = "center", va: str = "center",
             rotate: bool = False) -> None:
        """Draw ``text`` anchored at (x, y): ``ha`` left / center / right,
        ``va`` top / center / bottom of its box; ``rotate`` turns it 90
        degrees counter-clockwise (read bottom to top)."""
        mask = text_mask(text, size)
        if rotate:
            mask = np.rot90(mask)
        h, w = mask.shape
        x0 = {"left": x, "center": x - w / 2, "right": x - w}[ha]
        y0 = {"top": y, "center": y - h / 2, "bottom": y - h}[va]
        self.blend(int(round(x0)), int(round(y0)), mask, colour)

    def to_uint8(self) -> np.ndarray:
        return np.clip(np.round(self.pixels * 255.0), 0, 255).astype(np.uint8)

    def save(self, path: str | Path) -> None:
        """Write the canvas as an 8-bit RGBA PNG (opaque), as matplotlib's
        Agg backend writes a figure."""
        rgb = self.to_uint8()
        alpha = np.full(rgb.shape[:2] + (1,), 255, np.uint8)
        write_png(path, np.concatenate([rgb, alpha], axis=2))
