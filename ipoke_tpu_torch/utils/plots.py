"""The statistical plots of the ``--test`` modes' artifacts (counterpart of
``ipoke_tpu/utils/plots.py``; reference ``utils/logging.py:979-1160``):
per-frame errorbar lines grouped by poke count (``make_errorbar_plot``,
``make_nn_var_plot`` with its CSV), the mean and std against the poke count
(``make_two_axes_plot``) and violin distributions (``make_violin_plot``).

matplotlib and pandas are not dependencies of the port: a frame is a dict
of equal-length columns, ``to_csv`` writes it as pandas' ``to_csv`` does
(an unnamed index column first; each value as numpy prints it), and
``group_mean`` is ``groupby(key, as_index=False).mean(numeric_only=True)``.
The figures are drawn with cv2 (``draw_series``) and written as PNG, or as
a one-page PDF holding the JPEG-coded raster (``save_figure``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Frame = Dict[str, Sequence]
# seaborn's default palette, RGB
PALETTE = ((76, 114, 176), (221, 132, 82), (85, 168, 104), (196, 78, 82),
           (129, 114, 179), (147, 120, 96), (218, 139, 195), (140, 140, 140))


def _columns(frame: Frame) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in frame.items()}


def to_csv(frame: Frame, path: str) -> str:
    """``pandas.DataFrame.from_dict(frame).to_csv(path)``'s text."""
    cols = _columns(frame)
    n = len(next(iter(cols.values())))
    with open(path, "w") as f:
        f.write("," + ",".join(cols) + "\n")
        for i in range(n):
            f.write(",".join([str(i)] + [str(c[i]) for c in cols.values()]) + "\n")
    return path


def _mean(values: np.ndarray, dtype) -> np.ndarray:
    """pandas' group mean: a compensated (Kahan) sum in row order in
    ``dtype``, over the count."""
    total = comp = dtype(0)
    for v in values.astype(dtype):
        y = v - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return total / dtype(len(values))


def group_mean(frame: Frame, key: str) -> Dict[str, np.ndarray]:
    """Per value of ``key`` (sorted), the mean of every other numeric column:
    floats keep their dtype, integers become float64 (pandas' rule)."""
    cols = _columns(frame)
    keys = np.unique(cols[key])
    out = {key: keys}
    for name, col in cols.items():
        if name == key or col.dtype.kind not in "iuf":
            continue
        dtype = col.dtype.type if col.dtype.kind == "f" else np.float64
        out[name] = np.asarray([_mean(col[cols[key] == k], dtype) for k in keys], dtype)
    return out


def draw_series(series: List[Tuple[str, np.ndarray, np.ndarray, Optional[np.ndarray]]],
                xlabel: str, ylabel: str, title: Optional[str] = None,
                size: Tuple[int, int] = (640, 480), alpha: float = 0.3) -> np.ndarray:
    """An RGB uint8 image of line plots: per entry (label, x, y, band), a
    line with diamond markers and, where ``band`` is given, a shaded
    y +- band region; a legend in the upper left."""
    import cv2

    w, h = size
    left, right, top, bottom = 70, 20, 30 if title else 15, 45
    img = np.full((h, w, 3), 255, np.uint8)
    xs = np.concatenate([np.asarray(s[1], np.float64) for s in series])
    lo_y = [np.asarray(s[2], np.float64) - (0 if s[3] is None else s[3]) for s in series]
    hi_y = [np.asarray(s[2], np.float64) + (0 if s[3] is None else s[3]) for s in series]
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(np.min(np.concatenate(lo_y))), float(np.max(np.concatenate(hi_y)))
    x1 = x1 if x1 > x0 else x0 + 1.0
    pad = 0.05 * (y1 - y0) if y1 > y0 else 1.0
    y0, y1 = y0 - pad, y1 + pad

    def px(x, y):
        u = left + (np.asarray(x, np.float64) - x0) / (x1 - x0) * (w - left - right)
        v = h - bottom - (np.asarray(y, np.float64) - y0) / (y1 - y0) * (h - top - bottom)
        return np.stack([u, v], -1).round().astype(np.int32)

    grey, black = (200, 200, 200), (0, 0, 0)
    font = cv2.FONT_HERSHEY_SIMPLEX
    for t in np.linspace(y0, y1, 5):
        (u0, v), (u1, _) = px([x0, x1], [t, t])
        cv2.line(img, (int(u0), int(v)), (int(u1), int(v)), grey, 1)
        cv2.putText(img, f"{t:.3g}", (5, int(v) + 4), font, 0.4, black, 1)
    for t in np.unique(xs):
        (u, v), = px([t], [y0])
        cv2.putText(img, f"{t:g}", (int(u) - 5, int(v) + 15), font, 0.4, black, 1)
    cv2.rectangle(img, (left, top), (w - right, h - bottom), black, 1)
    for i, (label, x, y, band) in enumerate(series):
        colour = PALETTE[i % len(PALETTE)]
        if band is not None:
            poly = np.concatenate([px(x, np.asarray(y) - band),
                                   px(x, np.asarray(y) + band)[::-1]])
            shade = img.copy()
            cv2.fillPoly(shade, [poly], colour)
            img = cv2.addWeighted(shade, alpha, img, 1 - alpha, 0)
        pts = px(x, y)
        cv2.polylines(img, [pts], False, colour, 2)
        for u, v in pts:
            cv2.drawMarker(img, (int(u), int(v)), colour, cv2.MARKER_DIAMOND, 8, 2)
        cv2.putText(img, str(label), (left + 8, top + 16 + 16 * i), font, 0.45, colour, 1)
    cv2.putText(img, xlabel, (w // 2 - 4 * len(xlabel), h - 8), font, 0.45, black, 1)
    cv2.putText(img, ylabel, (left + 4, h - bottom - 6), font, 0.4, black, 1)
    if title:
        cv2.putText(img, title, (left, 20), font, 0.5, black, 1)
    return img


def _pdf_with_image(rgb: np.ndarray) -> bytes:
    """A one-page PDF whose page is the image, JPEG-coded (DCTDecode)."""
    import cv2

    ok, jpg = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 95])
    if not ok:
        raise ValueError("JPEG encoding failed")
    h, w = rgb.shape[:2]
    data = jpg.tobytes()
    draw = f"q {w} 0 0 {h} 0 0 cm /Im0 Do Q".encode()
    objs = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {w} {h}] "
         "/Resources << /XObject << /Im0 4 0 R >> >> /Contents 5 0 R >>").encode(),
        (f"<< /Type /XObject /Subtype /Image /Width {w} /Height {h} "
         "/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter /DCTDecode "
         f"/Length {len(data)} >>\nstream\n").encode() + data + b"\nendstream",
        f"<< /Length {len(draw)} >>\nstream\n".encode() + draw + b"\nendstream",
    ]
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, obj in enumerate(objs, 1):
        offsets.append(len(out))
        out += f"{i} 0 obj\n".encode() + obj + b"\nendobj\n"
    xref = len(out)
    out += f"xref\n0 {len(objs) + 1}\n0000000000 65535 f \n".encode()
    for off in offsets:
        out += f"{off:010d} 00000 n \n".encode()
    out += (f"trailer\n<< /Size {len(objs) + 1} /Root 1 0 R >>\n"
            f"startxref\n{xref}\n%%EOF\n").encode()
    return bytes(out)


def save_figure(path: str, rgb: np.ndarray) -> str:
    """Write an RGB image as a PDF (``.pdf``) or through cv2 (else)."""
    import cv2

    if path.lower().endswith(".pdf"):
        with open(path, "wb") as f:
            f.write(_pdf_with_image(rgb))
    elif not cv2.imwrite(path, np.ascontiguousarray(rgb[..., ::-1])):
        raise OSError(f"could not write {path}")
    return path


def make_errorbar_plot(fname: str, data: Frame, xid: str, yid: str, hueid: str,
                       varid: Optional[str] = None) -> None:
    """Per-``xid`` mean of ``yid``, one line per ``hueid`` group, with a
    +-var/2 band where ``varid`` names a column (reference
    ``make_errorbar_plot``)."""
    cols = _columns(data)
    series = []
    for g in dict.fromkeys(cols[hueid].tolist()):
        keep = cols[hueid] == g
        sub = group_mean({k: v[keep] for k, v in cols.items()}, xid)
        band = 0.5 * sub[varid] if varid is not None and varid in sub else None
        label = g if isinstance(g, str) else f"{g} Pokes"
        series.append((label, sub[xid], sub[yid], band))
    save_figure(fname, draw_series(series, xid, yid))


def make_nn_var_plot(n_pokes: int, nn_per_frame, savedir: str,
                     std_per_frame=None, save_csv: bool = True) -> str:
    """The per-frame nearest-neighbour MSE artifact set: its CSV and the
    errorbar PDF (reference ``make_nn_var_plot``, utils/logging.py:
    1013-1030); returns the PDF's path."""
    import os

    os.makedirs(savedir, exist_ok=True)
    nn_per_frame = np.asarray(nn_per_frame)
    n = nn_per_frame.shape[0]
    data = {"frame_id": np.arange(n), "nn_mse_err": nn_per_frame,
            "poke_indicator": [f"{n_pokes} poke vectors"] * n}
    if std_per_frame is not None:
        std_per_frame = np.asarray(std_per_frame)
        assert std_per_frame.shape[0] == n
        data["std_per_frame"] = std_per_frame
    if save_csv:
        to_csv(data, os.path.join(savedir, f"keypoint_err_data_{n_pokes}_pokes.csv"))
    fig = os.path.join(savedir, f"keypoint_err_{n_pokes}_pokes.pdf")
    make_errorbar_plot(fig, data, "frame_id", "nn_mse_err", "poke_indicator",
                       "std_per_frame" if std_per_frame is not None else None)
    return fig


def make_two_axes_plot(data: Frame, savepath: str, key_y1: str = "Mean MSE",
                       key_y2: str = "Std", x: str = "Number of Pokes",
                       title: str = "") -> None:
    """The per-poke-count mean of ``<key_y1> per Frame`` and of ``<key_y2>
    per Frame`` (reference ``make_two_axes_plot``, utils/logging.py:
    1052-1105, a twin-axis figure): here two panels, one above the other,
    each on its own y axis."""
    df = group_mean(data, x)
    xs = df[x].astype(int)
    panels = [draw_series([(key, xs, df[f"{key} per Frame"], None)], x, key,
                          title=(title or None) if i == 0 else None)
              for i, key in enumerate((key_y1, key_y2))]
    save_figure(savepath, np.concatenate(panels, axis=0))


def _kde(values: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """A Gaussian kernel density at Scott's bandwidth (matplotlib's
    ``violinplot`` default)."""
    bw = values.std(ddof=1) * values.size ** -0.2 or 1.0
    d = (grid[:, None] - values[None, :]) / bw
    return np.exp(-0.5 * d ** 2).sum(axis=1)


def make_violin_plot(fname: str, data: Frame, xid: str = "Method",
                     yid: str = "Mean Squared KP Error", order: Optional[Sequence[str]] = None,
                     zscore_cut: float = 3.0, title: Optional[str] = None,
                     size: Tuple[int, int] = (800, 400)) -> None:
    """Per-group violins (kernel densities) with the group means as dots,
    after a |z| < ``zscore_cut`` outlier filter over all values (the JAX
    package's; the reference stubs it, utils/logging.py:1107-1108)."""
    import cv2

    cols = _columns(data)
    y = cols[yid].astype(np.float64)
    keep = np.abs((y - y.mean()) / (y.std() or 1.0)) < zscore_cut
    groups = list(order) if order is not None else list(dict.fromkeys(cols[xid][keep].tolist()))
    series = [y[keep & (cols[xid] == g)] for g in groups]
    w, h = size
    left, right, top, bottom = 70, 20, 30 if title else 15, 45
    img = np.full((h, w, 3), 255, np.uint8)
    present = np.concatenate([s for s in series if s.size]) if any(s.size for s in series) \
        else np.zeros(1)
    y0, y1 = float(present.min()), float(present.max())
    pad = 0.05 * (y1 - y0) if y1 > y0 else 1.0
    y0, y1 = y0 - pad, y1 + pad
    step = (w - left - right) / max(1, len(groups))
    u = lambda i: left + step * (i + 0.5)
    v = lambda val: h - bottom - (np.asarray(val) - y0) / (y1 - y0) * (h - top - bottom)
    grey, black, font = (200, 200, 200), (0, 0, 0), cv2.FONT_HERSHEY_SIMPLEX
    for t in np.linspace(y0, y1, 5):
        cv2.line(img, (left, int(v(t))), (w - right, int(v(t))), grey, 1)
        cv2.putText(img, f"{t:.3g}", (5, int(v(t)) + 4), font, 0.4, black, 1)
    cv2.rectangle(img, (left, top), (w - right, h - bottom), black, 1)
    for i, (g, s) in enumerate(zip(groups, series)):
        colour = PALETTE[i % len(PALETTE)]
        if s.size > 1:
            grid = np.linspace(s.min(), s.max(), 100)
            dens = _kde(s, grid)
            half = 0.4 * step * dens / dens.max()
            poly = np.concatenate([np.stack([u(i) - half, v(grid)], -1),
                                   np.stack([u(i) + half, v(grid)], -1)[::-1]])
            cv2.fillPoly(img, [poly.round().astype(np.int32)], colour)
        if s.size:
            cv2.circle(img, (int(u(i)), int(v(s.mean()))), 4, black, -1)
        cv2.putText(img, str(g), (int(u(i)) - 4 * len(str(g)), h - bottom + 18), font,
                    0.45, black, 1)
    cv2.putText(img, yid, (left + 4, top + 14), font, 0.4, black, 1)
    if title:
        cv2.putText(img, title, (left, 20), font, 0.5, black, 1)
    save_figure(fname, img)
