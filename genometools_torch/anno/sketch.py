"""AnnotationSketch: feature diagram layout + SVG rendering.

The port's copy of ``genometools_tpu/anno/sketch.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference annotationsketch stack
(ref: src/annotationsketch/: diagram.c, layout.c, track.c, line.c,
block.c, canvas_cairo*.c, `gt sketch`). The Cairo canvas is replaced by
a dependency-free SVG writer; the layout model is the same: features
grouped into per-type tracks, packed greedily into non-overlapping
lines, child blocks (exons/CDS) drawn inside their parent's extent with
strand arrows and connecting lines.
"""

from __future__ import annotations

import html
from dataclasses import dataclass, field

from .genome_node import FeatureNode, GenomeNode, Range

_TRACK_COLORS = {
    "gene": "#9fb6cd",
    "mRNA": "#bcd2ee",
    "exon": "#b4eeb4",
    "CDS": "#ffdab9",
    "intron": "#ffffff",
    "LTR_retrotransposon": "#e9967a",
    "long_terminal_repeat": "#f0e68c",
    "repeat_region": "#dda0dd",
}
_DEFAULT_COLOR = "#d3d3d3"


@dataclass
class Block:
    """A drawable: top-level feature + its visible children
    (ref: block.c)."""
    node: FeatureNode
    range: Range
    caption: str


@dataclass
class Line:
    blocks: list[Block] = field(default_factory=list)

    def fits(self, rng: Range, gap: int) -> bool:
        return all(b.range.end + gap < rng.start or
                   rng.end + gap < b.range.start for b in self.blocks)


@dataclass
class Track:
    """Features of one type, packed into lines (ref: track.c/line.c)."""
    ftype: str
    lines: list[Line] = field(default_factory=list)

    def insert(self, block: Block, gap: int) -> None:
        for line in self.lines:
            if line.fits(block.range, gap):
                line.blocks.append(block)
                return
        self.lines.append(Line([block]))


@dataclass
class Diagram:
    """Layout of one sequence region (ref: diagram.c)."""
    seqid: str
    view: Range
    tracks: list[Track] = field(default_factory=list)

    @classmethod
    def from_nodes(cls, nodes: list[GenomeNode], seqid: str | None = None,
                   view: Range | None = None, gap_bp: int = 0) -> "Diagram":
        feats = [m for n in nodes if isinstance(n, FeatureNode)
                 for m in n.traverse()
                 if seqid is None or m.seqid == seqid]
        if not feats:
            return cls(seqid or "", view or Range(1, 1))
        sid = seqid or feats[0].seqid
        feats = [f for f in feats if f.seqid == sid]
        if view is None:
            view = Range(min(f.range.start for f in feats),
                         max(f.range.end for f in feats))
        feats = [f for f in feats if f.range.overlaps(view)]
        diagram = cls(sid, view)
        by_type: dict[str, Track] = {}
        for f in feats:
            track = by_type.setdefault(f.type, Track(f.type))
            caption = f.get_attribute("Name") or f.get_attribute("ID") or ""
            track.insert(Block(f, f.range, caption), gap_bp)
        diagram.tracks = [by_type[t] for t in sorted(by_type)]
        return diagram


class RecMap:
    """One drawn feature rectangle (ref:
    src/annotationsketch/rec_map.c GtRecMap: nw/se corners + node)."""

    def __init__(self, nw_x, nw_y, se_x, se_y, node):
        self.nw_x, self.nw_y = float(nw_x), float(nw_y)
        self.se_x, self.se_y = float(se_x), float(se_y)
        self.node = node

    def html_imagemap_coords(self) -> str:
        """ref: rec_map.c gt_rec_map_format_html_imagemap_coords —
        '%.0f,%.0f,%.0f,%.0f'."""
        return (f"{self.nw_x:.0f},{self.nw_y:.0f},"
                f"{self.se_x:.0f},{self.se_y:.0f}")


class ImageInfo:
    """Pixel rectangles of the drawn features, for HTML image maps
    (ref: src/annotationsketch/image_info.c GtImageInfo)."""

    def __init__(self):
        self.rec_maps: list[RecMap] = []
        self.height = 0

    def add_rec_map(self, rm: RecMap) -> None:
        self.rec_maps.append(rm)


class SVGCanvas:
    """Minimal SVG writer standing in for canvas_cairo (ref: canvas.c)."""

    def __init__(self, width: int = 800, margin: int = 20,
                 bar_height: int = 12, line_gap: int = 8,
                 track_gap: int = 18):
        self.width = width
        self.margin = margin
        self.bar_height = bar_height
        self.line_gap = line_gap
        self.track_gap = track_gap

    def render(self, diagram: Diagram,
               image_info: "ImageInfo | None" = None) -> str:
        view = diagram.view
        span = max(view.length, 1)
        inner = self.width - 2 * self.margin

        def x(pos: int) -> float:
            return self.margin + (pos - view.start) / span * inner

        parts = []
        y = self.margin
        # ruler
        parts.append(
            f'<line x1="{self.margin}" y1="{y}" x2="{self.width - self.margin}"'
            f' y2="{y}" stroke="#888"/>')
        parts.append(
            f'<text x="{self.margin}" y="{y - 5}" font-size="10">'
            f'{html.escape(diagram.seqid)}: {view.start}..{view.end}</text>')
        y += self.track_gap
        for track in diagram.tracks:
            parts.append(f'<text x="{self.margin}" y="{y + 9}" '
                         f'font-size="10" font-style="italic">'
                         f'{html.escape(track.ftype)}</text>')
            y += 14
            color = _TRACK_COLORS.get(track.ftype, _DEFAULT_COLOR)
            for line in track.lines:
                for block in line.blocks:
                    x0 = x(max(block.range.start, view.start))
                    x1 = x(min(block.range.end, view.end))
                    w = max(x1 - x0, 1.0)
                    strand = block.node.strand
                    parts.append(
                        f'<rect x="{x0:.1f}" y="{y}" width="{w:.1f}" '
                        f'height="{self.bar_height}" fill="{color}" '
                        f'stroke="#555"/>')
                    if image_info is not None:
                        image_info.add_rec_map(RecMap(
                            x0, y, x0 + w, y + self.bar_height,
                            block.node))
                    if strand in "+-" and w > 8:
                        ax = x1 - 6 if strand == "+" else x0 + 6
                        tip = x1 if strand == "+" else x0
                        mid = y + self.bar_height / 2
                        parts.append(
                            f'<path d="M {ax:.1f} {y} L {tip:.1f} {mid:.1f} '
                            f'L {ax:.1f} {y + self.bar_height}" '
                            f'fill="none" stroke="#555"/>')
                    if block.caption and w > 30:
                        parts.append(
                            f'<text x="{x0:.1f}" y="{y - 2}" font-size="9">'
                            f'{html.escape(block.caption)}</text>')
                y += self.bar_height + self.line_gap
            y += self.track_gap - self.line_gap
        height = y + self.margin
        if image_info is not None:
            image_info.height = height
        return (f'<svg xmlns="http://www.w3.org/2000/svg" '
                f'width="{self.width}" height="{height}">\n'
                f'<rect width="100%" height="100%" fill="white"/>\n'
                + "\n".join(parts) + "\n</svg>\n")


class RasterCanvas:
    """PNG/PDF canvas via PIL (capability equivalent of the reference's
    cairo file canvases, ref: src/annotationsketch/canvas_cairo_file.c);
    same layout geometry as SVGCanvas."""

    def __init__(self, width: int = 800, margin: int = 20,
                 bar_height: int = 12, line_gap: int = 8,
                 track_gap: int = 18, styles: dict | None = None):
        self.width = width
        self.margin = margin
        self.bar_height = bar_height
        self.line_gap = line_gap
        self.track_gap = track_gap
        self.styles = styles or {}

    def _colors(self, ftype: str) -> tuple[str, str]:
        sec = self.styles.get(ftype, {})
        fill = sec.get("fill") or _TRACK_COLORS.get(ftype, _DEFAULT_COLOR)
        stroke = sec.get("stroke") or "#555555"
        return fill, stroke

    def _measure(self, diagram: Diagram) -> int:
        y = self.margin + self.track_gap
        for track in diagram.tracks:
            y += 14
            y += len(track.lines) * (self.bar_height + self.line_gap)
            y += self.track_gap - self.line_gap
        return y + self.margin

    def render(self, diagram: Diagram,
               image_info: "ImageInfo | None" = None):
        """Returns a PIL Image of the diagram."""
        from PIL import Image, ImageDraw
        view = diagram.view
        span = max(view.length, 1)
        inner = self.width - 2 * self.margin

        def x(pos: int) -> float:
            return self.margin + (pos - view.start) / span * inner

        height = self._measure(diagram)
        img = Image.new("RGB", (self.width, height), "white")
        d = ImageDraw.Draw(img)
        y = self.margin
        d.line([(self.margin, y), (self.width - self.margin, y)],
               fill="#888888")
        d.text((self.margin, y - 12),
               f"{diagram.seqid}: {view.start}..{view.end}",
               fill="black")
        y += self.track_gap
        for track in diagram.tracks:
            d.text((self.margin, y), track.ftype, fill="#333333")
            y += 14
            fill, stroke = self._colors(track.ftype)
            for line in track.lines:
                for block in line.blocks:
                    x0 = x(max(block.range.start, view.start))
                    x1 = x(min(block.range.end, view.end))
                    x1 = max(x1, x0 + 1)
                    d.rectangle([x0, y, x1, y + self.bar_height],
                                fill=fill, outline=stroke)
                    if image_info is not None:
                        image_info.add_rec_map(RecMap(
                            x0, y, x1, y + self.bar_height,
                            block.node))
                    strand = block.node.strand
                    if strand in "+-" and x1 - x0 > 8:
                        ax = x1 - 6 if strand == "+" else x0 + 6
                        tip = x1 if strand == "+" else x0
                        mid = y + self.bar_height / 2
                        d.line([(ax, y), (tip, mid),
                                (ax, y + self.bar_height)], fill=stroke)
                    if block.caption and x1 - x0 > 30:
                        d.text((x0, y - 12), block.caption,
                               fill="black")
                y += self.bar_height + self.line_gap
            y += self.track_gap - self.line_gap
        return img


def sketch(nodes: list[GenomeNode], seqid: str | None = None,
           width: int = 800, fmt: str = "svg",
           style: dict | None = None,
           view: "Range | None" = None,
           image_info: "ImageInfo | None" = None):
    """`gt sketch` equivalent. fmt="svg" returns the SVG string;
    "png"/"pdf" return the encoded image bytes (PIL canvas).
    image_info, when given, collects the drawn feature rectangles
    (ref: gt_sketch.c:421 gt_image_info_new + -showrecmaps)."""
    diagram = Diagram.from_nodes(nodes, seqid, view=view)
    styles = {}
    if style:
        from .style import track_colors
        styles = track_colors(style)
    if fmt == "svg":
        canvas = SVGCanvas(width=width)
        if styles:
            for t, e in styles.items():
                if "fill" in e:
                    _TRACK_COLORS[t] = e["fill"]
        return canvas.render(diagram, image_info=image_info)
    import io
    img = RasterCanvas(width=width, styles=styles).render(
        diagram, image_info=image_info)
    buf = io.BytesIO()
    img.save(buf, format=fmt.upper())
    return buf.getvalue()


def sketch_pages(nodes: list[GenomeNode], seqid: str | None = None,
                 width: int = 800, page_span: int = 50000,
                 style: dict | None = None) -> bytes:
    """`gt sketch_page` equivalent (ref: src/tools/gt_sketch_page.c):
    paginate the full sequence range into page_span-bp views and render
    one page per view into a multi-page PDF."""
    import io
    diagram0 = Diagram.from_nodes(nodes, seqid)
    view = diagram0.view
    styles = {}
    if style:
        from .style import track_colors
        styles = track_colors(style)
    pages = []
    start = view.start
    while start <= view.end:
        end = min(start + page_span - 1, view.end)
        dia = Diagram.from_nodes(nodes, seqid, view=Range(start, end))
        pages.append(RasterCanvas(width=width, styles=styles).render(dia))
        start = end + 1
    buf = io.BytesIO()
    pages[0].save(buf, format="PDF", save_all=True,
                  append_images=pages[1:])
    return buf.getvalue()
