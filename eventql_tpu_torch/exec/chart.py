"""ChartSQL: render DRAW statements to SVG.

Re-implements the reference's chart pipeline — the csql chart
expression (reference: sql/extensions/chartsql/) on top of an SVG
chart renderer (reference: util/charts/): canvas layout, axis
placement, continuous/time domains, and the line/point/bar chart
drawables, with byte-identical SVG output (verified against golden
test 00004).

Layout notes replicated exactly from the reference:
* canvas 800x320, axis paddings (canvas.h:40-47), integer padding
  arithmetic (Viewport stores ints)
* axis labels/ticks are generated BEFORE the chart builds its domains
  (Canvas::render order, canvas.cc:56-66), so a single-valued y domain
  labels as its raw value while points scale over the built range
* continuous domains pad 10% at the top only when min != 0
  (continuousdomain.h:205-211); y domains get the default 0.1 padding
  (linechart.h addSeries)
* numeric x values adapt to a time domain (chartbuilder.h
  mkSeriesAdapter1D tries TimeType first), labeled per range
  (timedomain.cc:41-51 — thresholds compare microseconds against
  second constants, replicated as-is)
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.core.types import SType, format_timestamp
from eventql_tpu_torch.exec.chart_style import STYLESHEET_DEFAULT

# canvas constants (reference: util/charts/canvas.h:40-47)
K_AXIS_PADDING = 0
K_TICK_LENGTH = 5
K_AXIS_LABEL_HEIGHT = 25
K_AXIS_LABEL_WIDTH = 50
K_AXIS_TITLE_LENGTH = 20
K_TITLE_LINE_HEIGHT = 20
K_SUBTITLE_LINE_HEIGHT = 20

K_DEFAULT_NUM_TICKS = 8  # util/charts/domain.cc:34
K_DEFAULT_DOMAIN_PADDING = 0.1  # util/charts/domain.cc:35


def _fmt(v: float) -> str:
    return "%f" % (v,)


def _double_to_string(v: float) -> str:
    # reference: StringUtil::toString(double) — %f with trailing zeros
    # trimmed down to one decimal (stringutil.cc:99-111)
    s = "%f" % (v,)
    while len(s) > 2 and s.endswith("0") and s[-2] != ".":
        s = s[:-1]
    return s


def format_number_metric(value: float) -> str:
    # reference: StringUtil::formatNumberMetric (stringutil_impl.h:85-135)
    a = abs(value)
    if a == 0:
        return "0"
    if a < 0.000000001:
        return "%.1fp" % (value * 1000000000000)
    if a < 0.000001:
        return "%.1fn" % (value * 1000000000)
    if a < 0.001:
        return "%.1fμ" % (value * 1000000)
    if a < 0.1:
        return "%.1fm" % (value * 1000)
    if a < 10:
        return "%.2f" % value
    if a < 1000:
        return "%.1f" % value
    if a < 1000000:
        return "%.1fK" % (value / 1000)
    if a < 1000000000:
        return "%.1fM" % (value / 1000000)
    if a < 1000000000000:
        return "%.1fG" % (value / 1000000000)
    return "%.1fT" % (value / 1000000000000)


class SVGTarget:
    """reference: util/charts/svgtarget.h"""

    def __init__(self):
        self.out: List[str] = []
        self.indent = 0

    def _line(self, s: str):
        self.out.append(" " * (self.indent * 2) + s)

    def begin_chart(self, width: int, height: int, class_name: str):
        self._line(f"<svg viewBox='0 0 {width} {height}' class='{class_name}'>\n")
        self.indent += 1
        self._line("<style type='text/css'>\n")
        self._line(f"<![CDATA[{STYLESHEET_DEFAULT}  ]]>\n")
        self._line("</style>\n")

    def finish_chart(self):
        self.indent -= 1
        self._line("</svg>\n")

    def begin_group(self, class_name: str):
        self._line(f"<g class='{class_name}'>\n")
        self.indent += 1

    def finish_group(self):
        self.indent -= 1
        self._line("</g>\n")

    def draw_line(self, x1, y1, x2, y2, class_name):
        self._line(
            "<line x1='%s' y1='%s' x2='%s' y2='%s' class='%s' />\n"
            % (_fmt(x1), _fmt(y1), _fmt(x2), _fmt(y2), class_name)
        )

    def draw_text(self, text, x, y, halign, valign, class_name, rotate=0.0):
        if rotate == 0.0:
            transform = ""
        else:
            transform = "transform='translate(0,0) rotate(%f %f %f)'" % (
                rotate,
                x,
                y,
            )
        self._line(
            "<text x='%s' y='%s' style='text-anchor:%s; dominant-baseline:%s;'"
            " class='%s' %s>%s</text>\n"
            % (_fmt(x), _fmt(y), halign, valign, class_name, transform, text)
        )

    def draw_point(
        self, x, y, point_type, point_size, color, class_name, label, series
    ):
        class_str = class_name + " "
        style_str = ""
        if 3 < len(color) < 8 and color.startswith("#"):
            style_str = "fill: " + color + ";"
        else:
            class_str += color
        r = 0.0 if point_type == "none" else point_size
        self._line(
            "<circle cx='%s' cy='%s' r='%s' class='%s' fm:label='%s' "
            "fm:series='%s', style='%s'></circle>\n"
            % (_fmt(x), _fmt(y), _fmt(r), class_str, label, series, style_str)
        )

    def draw_path(self, points, line_style, line_width, smooth, color, class_name):
        class_str = class_name + " "
        style_str = ""
        if 3 < len(color) < 8 and color.startswith("#"):
            style_str = "stroke: " + color + ";"
        else:
            class_str += color
        d = ""
        for i, (x, y) in enumerate(points):
            d += ("M%s %s " if i == 0 else "L%s %s ") % (_fmt(x), _fmt(y))
        self._line(
            "<path stroke-width='%s' class='%s' style='%s' d='%s' />\n"
            % (_fmt(line_width), class_str, style_str, d)
        )

    def draw_rect(self, x, y, width, height, color, class_name, label, series):
        class_str = class_name + " "
        style_str = ""
        if 3 < len(color) < 8 and color.startswith("#"):
            style_str = "fill: " + color + ";"
        else:
            class_str += color
        self._line(
            "<rect x='%s' y='%s' width='%s' height='%s' class='%s' "
            "fm:series='%s' fm:label='%s' style='%s'></rect>\n"
            % (
                _fmt(x),
                _fmt(y),
                _fmt(width),
                _fmt(height),
                class_str,
                series,
                label,
                style_str,
            )
        )

    def svg(self) -> str:
        return "".join(self.out)


class Viewport:
    """reference: util/charts/viewport.h — padding is integer."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.padding = [0, 0, 0, 0]  # top, right, bottom, left

    @property
    def inner_width(self):
        return self.width - self.padding[1] - self.padding[3]

    @property
    def inner_height(self):
        return self.height - self.padding[0] - self.padding[2]


class ContinuousDomain:
    """reference: util/charts/continuousdomain.h"""

    is_time = False

    def __init__(self):
        self.min_value = float("inf")
        self.max_value = float("-inf")
        self.padding = (0.0, 0.0)
        self.built = False
        self.is_inverted = False
        self.is_logarithmic = False

    def add_value(self, v: float):
        v = float(v)
        self.min_value = min(self.min_value, v)
        self.max_value = max(self.max_value, v)

    def set_padding(self, lo, hi):
        self.padding = (lo, hi)

    def set_min(self, v):
        # fixing a bound also drops its padding
        # (reference: continuousdomain.h:173-181)
        self.min_value = float(v)
        self.padding = (0.0, self.padding[1])

    def set_max(self, v):
        self.max_value = float(v)
        self.padding = (self.padding[0], 0.0)

    def set_inverted(self, inverted: bool):
        self.is_inverted = inverted

    def set_logarithmic(self, logarithmic: bool):
        self.is_logarithmic = logarithmic

    def build(self):
        if self.built:
            return
        self.built = True
        if self.min_value == self.max_value:
            self.max_value += 1.0
            self.min_value -= 1.0

    def _range_with_padding(self):
        rng = self.max_value - self.min_value
        lo = 0 if self.min_value == 0 else self.min_value - rng * self.padding[0]
        hi = self.max_value + rng * self.padding[1]
        return lo, hi

    def _max_log(self):
        if self.min_value < 0:
            raise RuntimeError_(
                "negative value is outside of logarithmic domain"
            )
        if self.max_value >= 1.0:
            return math.log10(
                self.max_value + self.max_value * self.padding[1]
            )
        return 0.0

    def scale(self, v: float) -> float:
        # reference: continuousdomain.h:60-95
        if self.is_logarithmic:
            max_log = self._max_log()
            value_log = (
                math.log10(float(v)) if float(v) >= 1.0 else 0.0
            )
            scaled = value_log / max_log if max_log else 0.0
        else:
            lo, hi = self._range_with_padding()
            scaled = (float(v) - lo) / (hi - lo)
        return 1.0 - scaled if self.is_inverted else scaled

    def value_at(self, index: float) -> float:
        # reference: continuousdomain.h:100-131
        if self.is_logarithmic:
            max_log = self._max_log()
            idx = (1.0 - index) if self.is_inverted else index
            return math.pow(10, idx * max_log)
        lo, hi = self._range_with_padding()
        idx = (1.0 - index) if self.is_inverted else index
        return lo + (hi - lo) * idx

    def label(self, v: float) -> str:
        return format_number_metric(v)

    def get_ticks(self) -> List[float]:
        n = K_DEFAULT_NUM_TICKS
        return [i / (n - 1) for i in range(n)]

    def get_labels(self) -> List[Tuple[float, str]]:
        return [(t, self.label(self.value_at(t))) for t in self.get_ticks()]


class TimeDomain(ContinuousDomain):
    """reference: util/charts/timedomain.cc — note the thresholds
    compare a microsecond range against second constants (a reference
    quirk kept for parity)."""

    is_time = True

    def label(self, v: float) -> str:
        rng = self.max_value - self.min_value
        micros = int(v)
        if rng < 60 * 60:
            fmt = "%H:%M:%S"
        elif rng < 60 * 60 * 24:
            fmt = "%H:%M"
        else:
            fmt = "%Y-%m-%d %H:%M"
        import time as _time

        try:
            return _time.strftime(fmt, _time.gmtime(micros // 1000000))
        except (OverflowError, OSError, ValueError):
            return ""


class DiscreteDomain:
    """reference: util/charts/discretedomain.h

    Quirk kept for parity: the reference computes the category index as
    `categories.end() - find(...)`, i.e. the distance from the found
    element to the END — so the FIRST category added scales closest to
    1.0 and later categories walk toward 0 (discretedomain.h:45-83)."""

    is_time = False

    def __init__(self):
        self.categories: List = []
        self.built = False
        self.is_inverted = False

    def add_value(self, v):
        if v not in self.categories:
            self.categories.append(v)

    def build(self):
        self.built = True

    def _rindex(self, v) -> int:
        # reference: index = end - find = n - pos; 0 means "not found"
        try:
            return len(self.categories) - self.categories.index(v)
        except ValueError:
            raise RuntimeError_("can't scale value")

    def set_inverted(self, inverted: bool):
        self.is_inverted = inverted

    def scale(self, v) -> float:
        idx = self._rindex(v)
        if idx < 1:
            raise RuntimeError_("can't scale value")
        scaled = (idx - 0.5) / len(self.categories)
        return 1.0 - scaled if getattr(self, "is_inverted", False) else scaled

    def scale_range(self, v):
        idx = self._rindex(v)
        if idx < 1:
            raise RuntimeError_("can't scale value")
        n = len(self.categories)
        begin, end = (idx - 1) / n, idx / n
        if getattr(self, "is_inverted", False):
            return (1.0 - begin, 1.0 - end)
        return (begin, end)

    def get_ticks(self):
        out = [0.0]
        for c in self.categories:
            out.append(self.scale_range(c)[1])
        return out

    def get_labels(self):
        return [(self.scale(c), self.label(c)) for c in self.categories]

    def label(self, v) -> str:
        if isinstance(v, float):
            return _double_to_string(v)
        return str(v)


class Series:
    def __init__(self, name: str):
        self.name = name
        self.points: List[Tuple[object, object, str]] = []  # x, y, label
        self.properties: Dict[str, str] = {}

    def prop(self, key, default=None):
        return self.properties.get(key, default)


class AxisDefinition:
    """reference: util/charts/axisdefinition.cc"""

    TOP, RIGHT, BOTTOM, LEFT = "top", "right", "bottom", "left"

    def __init__(self, position, domain=None):
        self.position = position
        self.domain = domain
        self.title = ""
        self.has_labels_flag = True

    def has_title(self):
        return bool(self.title)

    def has_labels(self):
        return self.has_labels_flag and self.domain is not None

    def get_labels(self):
        return self.domain.get_labels() if self.domain else []

    def get_ticks(self):
        return self.domain.get_ticks() if self.domain else []


_COLOR_PALETTE = ["color1", "color2", "color3", "color4", "color5", "color6"]


class GridDefinition:
    """reference: util/charts/griddefinition.h — placement + the domain
    whose ticks position the gridlines."""

    HORIZONTAL, VERTICAL = "horizontal", "vertical"

    def __init__(self, placement: str, domain=None):
        self.placement = placement
        self.domain = domain

    def ticks(self):
        return self.domain.get_ticks() if self.domain else []


class LegendDefinition:
    """reference: util/charts/legenddefinition.h — entries are
    (label, color, point_style) tuples."""

    def __init__(
        self,
        vert_pos: str = "bottom",
        horiz_pos: str = "left",
        placement: str = "outside",
        title: str = "",
    ):
        self.vert_pos = vert_pos
        self.horiz_pos = horiz_pos
        self.placement = placement
        self.title = title
        self.entries: List[Tuple[str, str, str]] = []

    def add_entry(self, label: str, color: str, point_style: str = "circle"):
        self.entries.append((label, color, point_style))


class LineChart:
    """reference: util/charts/linechart.h (LineChart2D)"""

    def __init__(self):
        self.x_domain = None
        self.y_domain = None
        self.series: List[Series] = []
        self._color_index = 0

    def add_series(self, series: Series, x_is_time: bool):
        if self.x_domain is None:
            self.x_domain = TimeDomain() if x_is_time else ContinuousDomain()
        if self.y_domain is None:
            self.y_domain = ContinuousDomain()
            self.y_domain.set_padding(
                K_DEFAULT_DOMAIN_PADDING, K_DEFAULT_DOMAIN_PADDING
            )
        for x, y, _label in series.points:
            self.x_domain.add_value(x)
            self.y_domain.add_value(y)
        if "color" not in series.properties:
            series.properties["color"] = _COLOR_PALETTE[
                self._color_index % len(_COLOR_PALETTE)
            ]
            self._color_index += 1
        series.properties.setdefault("linestyle", "solid")
        series.properties.setdefault("linewidth", "2")
        series.properties.setdefault("pointstyle", "none")
        series.properties.setdefault("pointsize", "3")
        self.series.append(series)

    def domain_for_axis(self, position):
        if position in (AxisDefinition.TOP, AxisDefinition.BOTTOM):
            return self.x_domain
        return self.y_domain

    def grid_domain(self, placement):
        # reference quirk kept: LineChart2D::addGrid maps VERTICAL
        # gridlines to the y domain and HORIZONTAL to x
        # (linechart.h:321-336; areachart.h and pointchart.h agree)
        if placement == GridDefinition.VERTICAL:
            return self.y_domain
        return self.x_domain

    def get_domain(self, dim: str):
        # reference: LineChart2D::getDomain (linechart.h:339-350)
        if dim == "x":
            return self.x_domain
        if dim == "y":
            return self.y_domain
        raise RuntimeError_(
            f"{type(self).__name__} does not have a Z domain"
        )

    def render(self, target: SVGTarget, viewport: Viewport):
        self.x_domain.build()
        self.y_domain.build()
        target.begin_group("lines")
        for series in self.series:
            coords = []
            point_style = series.prop("pointstyle")
            line_style = series.prop("linestyle")
            line_width = float(series.prop("linewidth"))
            point_size = float(series.prop("pointsize"))
            color = series.prop("color")
            for x, y, label in series.points:
                sx = self.x_domain.scale(x)
                sy = self.y_domain.scale(y)
                ss_x = viewport.padding[3] + sx * viewport.inner_width
                ss_y = viewport.padding[0] + (1.0 - sy) * viewport.inner_height
                target.draw_point(
                    ss_x, ss_y, point_style, point_size, color, "point", label,
                    series.name,
                )
                coords.append((ss_x, ss_y))
            target.draw_path(
                coords, line_style, line_width, False, color, "line"
            )
        target.finish_group()


class PointChart(LineChart):
    """reference: util/charts/pointchart.h"""

    def render(self, target, viewport):
        self.x_domain.build()
        self.y_domain.build()
        target.begin_group("points")
        for series in self.series:
            point_style = series.prop("pointstyle", "circle")
            point_size = float(series.prop("pointsize", "3"))
            color = series.prop("color")
            for x, y, label in series.points:
                sx = self.x_domain.scale(x)
                sy = self.y_domain.scale(y)
                ss_x = viewport.padding[3] + sx * viewport.inner_width
                ss_y = viewport.padding[0] + (1.0 - sy) * viewport.inner_height
                target.draw_point(
                    ss_x, ss_y, point_style, point_size, color, "point", label,
                    series.name,
                )
        target.finish_group()


class AreaChart(LineChart):
    """reference: util/charts/areachart.h (AreaChart2D semantics: each
    (x, y) point covers the surface between 0 and y). Stacked areas are
    unimplemented in the reference ("FIXPAUL: stacked areas",
    areachart.h:292) and therefore here too."""

    # reference: areachart.cc:33-36
    K_DEFAULT_LINE_STYLE = "none"
    K_DEFAULT_LINE_WIDTH = "1"
    K_DEFAULT_POINT_STYLE = "none"
    K_DEFAULT_POINT_SIZE = "2"

    def add_series(self, series: Series, x_is_time: bool):
        if self.x_domain is None:
            if any(isinstance(x, str) for x, _y, _l in series.points):
                self.x_domain = DiscreteDomain()
            else:
                self.x_domain = TimeDomain() if x_is_time else ContinuousDomain()
        if self.y_domain is None:
            self.y_domain = ContinuousDomain()
            self.y_domain.set_padding(
                K_DEFAULT_DOMAIN_PADDING, K_DEFAULT_DOMAIN_PADDING
            )
        for x, y, _label in series.points:
            self.x_domain.add_value(x)
            self.y_domain.add_value(0.0)  # 2D lower bound
            self.y_domain.add_value(y)
        if "color" not in series.properties:
            series.properties["color"] = _COLOR_PALETTE[
                self._color_index % len(_COLOR_PALETTE)
            ]
            self._color_index += 1
        series.properties.setdefault("linestyle", self.K_DEFAULT_LINE_STYLE)
        series.properties.setdefault("linewidth", self.K_DEFAULT_LINE_WIDTH)
        series.properties.setdefault("pointstyle", self.K_DEFAULT_POINT_STYLE)
        series.properties.setdefault("pointsize", self.K_DEFAULT_POINT_SIZE)
        self.series.append(series)

    def render(self, target: SVGTarget, viewport: Viewport):
        # reference: AreaChart3D::render (areachart.h:295-390)
        self.x_domain.build()
        self.y_domain.build()
        target.begin_group("areas")
        for series in self.series:
            point_style = series.prop("pointstyle")
            point_size = float(series.prop("pointsize"))
            line_style = series.prop("linestyle")
            line_width = float(series.prop("linewidth"))
            color = series.prop("color")

            area_coords = []
            border_top = []
            border_bottom = []
            for x, y, label in series.points:
                s_x = self.x_domain.scale(x)
                s_y2 = 1.0 - self.y_domain.scale(y)
                dx = viewport.padding[3] + s_x * viewport.inner_width
                dy2 = viewport.padding[0] + s_y2 * viewport.inner_height
                area_coords.append((dx, dy2))
                border_top.append((dx, dy2))
                target.draw_point(
                    dx, dy2, point_style, point_size, color, "point",
                    label, series.name,
                )
            for x, y_lo, label in [
                (x, 0.0, label) for x, _y, label in reversed(series.points)
            ]:
                s_x = self.x_domain.scale(x)
                s_y1 = 1.0 - self.y_domain.scale(y_lo)
                dx = viewport.padding[3] + s_x * viewport.inner_width
                dy1 = viewport.padding[0] + s_y1 * viewport.inner_height
                area_coords.append((dx, dy1))
                if y_lo != 0:
                    border_bottom.append((dx, dy1))
                    target.draw_point(
                        dx, dy1, point_style, point_size, color, "point",
                        label, series.name,
                    )
            target.draw_path(
                area_coords,
                "fill",
                0 if line_style == "none" else line_width,
                False,
                color,
                "area",
            )
            if line_style != "none":
                target.draw_path(
                    border_top, line_style, line_width, False, color, "line"
                )
                if border_bottom:
                    target.draw_path(
                        border_bottom, line_style, line_width, False, color,
                        "line",
                    )
        target.finish_group()


class BarChart:
    """reference: util/charts/barchart.h (BarChart2D semantics: one bar
    per point with label x and height y; positive y maps to the
    (0, y) range, negative y to (y, 0) — barchart.h:585-597; series
    sharing x labels render as grouped bars, or stacked when STACKED)."""

    K_BAR_PADDING = 0.3  # barchart.h:61
    K_BAR_PADDING_INNER = 0.2  # barchart.h:62
    K_LABEL_PADDING = 8  # barchart.h:63

    def __init__(self):
        self.x_domain: Optional[DiscreteDomain] = None
        self.y_domain: Optional[ContinuousDomain] = None
        self.series: List[Series] = []
        self._color_index = 0
        self.orientation = "vertical"
        self.stacked = False
        self.show_labels = False
        # SeriesJoin3D analog: bars keyed by x in first-appearance order
        self._bars: Dict[object, dict] = {}
        self._bar_order: List = []

    def add_series(self, series: Series, x_is_time: bool):
        if self.x_domain is None:
            self.x_domain = DiscreteDomain()
        if self.y_domain is None:
            self.y_domain = ContinuousDomain()
            self.y_domain.set_padding(
                K_DEFAULT_DOMAIN_PADDING, K_DEFAULT_DOMAIN_PADDING
            )
        n_series = len(self.series)
        for x, y, label in series.points:
            # BarChart2D::addSeries null-coord mapping (barchart.h:585)
            lo, hi = (0.0, float(y)) if y > 0 else (float(y), 0.0)
            self.x_domain.add_value(x)
            self.y_domain.add_value(lo)
            self.y_domain.add_value(hi)
            bar = self._bars.get(x)
            if bar is None:
                bar = {"ys": [(0.0, 0.0)] * n_series, "label": ""}
                self._bars[x] = bar
                self._bar_order.append(x)
            while len(bar["ys"]) < n_series:
                bar["ys"].append((0.0, 0.0))
            # SeriesJoin3D::addPoint drops duplicate x within one series
            # (seriesjoin.h:84-86) but still joins the label
            if len(bar["ys"]) < n_series + 1:
                bar["ys"].append((lo, hi))
            if not bar["label"]:
                bar["label"] = label
            elif bar["label"] != label:
                bar["label"] += ", " + label
        for x in self._bar_order:
            bar = self._bars[x]
            while len(bar["ys"]) < n_series + 1:
                bar["ys"].append((0.0, 0.0))
        if "color" not in series.properties:
            series.properties["color"] = _COLOR_PALETTE[
                self._color_index % len(_COLOR_PALETTE)
            ]
            self._color_index += 1
        self.series.append(series)
        self.set_stacked(self.stacked)

    def set_orientation(self, orientation: str):
        self.orientation = orientation

    def set_stacked(self, stacked: bool):
        # reference: BarChart3D::setStacked extends the y domain by each
        # bar's stacked total (barchart.h:546-560)
        self.stacked = stacked
        if stacked and self.y_domain is not None:
            for x in self._bar_order:
                total = 0.0
                for lo, hi in self._bars[x]["ys"]:
                    total += hi - lo
                self.y_domain.add_value(total)

    def set_labels(self, show: bool):
        self.show_labels = show

    def domain_for_axis(self, position):
        # reference: BarChart3D::addAxis swaps domains per orientation
        # (barchart.h:272-318)
        horizontal_axis = position in (
            AxisDefinition.TOP, AxisDefinition.BOTTOM
        )
        if self.orientation == "vertical":
            return self.x_domain if horizontal_axis else self.y_domain
        return self.y_domain if horizontal_axis else self.x_domain

    def get_domain(self, dim: str):
        # reference: BarChart3D::getDomain (barchart.h:564-576) —
        # DIM_Y and DIM_Z both map to the y domain
        return self.x_domain if dim == "x" else self.y_domain

    def grid_domain(self, placement):
        # reference: BarChart3D::addGrid (barchart.h:322-346)
        if placement == GridDefinition.VERTICAL:
            return (
                self.y_domain
                if self.orientation == "vertical"
                else self.x_domain
            )
        return (
            self.x_domain if self.orientation == "vertical" else self.y_domain
        )

    def _joined_bars(self):
        bars = [
            (x, self._bars[x]["ys"], self._bars[x]["label"])
            for x in self._bar_order
        ]
        if not self.stacked:
            return bars
        # reference: BarChart3D::stackData (barchart.h:511-532)
        stacked = []
        for x, ys, label in bars:
            cur = 0.0
            out = []
            for lo, hi in ys:
                delta = hi - lo
                out.append((cur, cur + delta))
                cur += delta
            stacked.append((x, out, label))
        return stacked

    def render(self, target: SVGTarget, viewport: Viewport):
        if self.x_domain is None or self.y_domain is None:
            raise RuntimeError_("BarChart#render called without any data")
        self.x_domain.build()
        self.y_domain.build()
        data = self._joined_bars()
        if self.orientation == "horizontal":
            target.begin_group("bars horizontal")
            self._render_horizontal(target, viewport, data)
        else:
            target.begin_group("bars vertical")
            self._render_vertical(target, viewport, data)
        target.finish_group()

    def _render_vertical(self, target, viewport, data):
        # reference: renderVerticalBars (barchart.h:451-509)
        n_series = len(self.series)
        for x, ys, bar_label in data:
            x_lo, x_hi = self.x_domain.scale_range(x)
            label_y = viewport.padding[0] + viewport.inner_height
            label_x = viewport.padding[3] + (
                x_lo + (x_hi - x_lo) * 0.5
            ) * viewport.inner_width
            for n in range(n_series):
                y_min = self.y_domain.scale(ys[n][0])
                y_max = self.y_domain.scale(ys[n][1])
                dw = (x_hi - x_lo) * viewport.inner_width
                dh = (y_max - y_min) * viewport.inner_height
                dx = viewport.padding[3] + x_lo * viewport.inner_width
                dy = viewport.padding[0] + (1.0 - y_max) * viewport.inner_height
                dx += dw * self.K_BAR_PADDING * 0.5
                dw *= 1.0 - self.K_BAR_PADDING
                if not self.stacked:
                    dw /= n_series
                    dx += dw * n + dw * self.K_BAR_PADDING_INNER * 0.5
                    dw *= 1.0 - self.K_BAR_PADDING_INNER
                target.draw_rect(
                    dx, dy, dw, dh,
                    self.series[n].prop("color"),
                    "bar", bar_label, self.series[n].name,
                )
                if dy < label_y:
                    label_y = dy
            if self.show_labels:
                target.draw_text(
                    bar_label, label_x, label_y - self.K_LABEL_PADDING,
                    "middle", "text-after-edge", "label",
                )

    def _render_horizontal(self, target, viewport, data):
        # reference: renderHorizontalBars (barchart.h:394-449)
        n_series = len(self.series)
        for x, ys, bar_label in data:
            x_lo, x_hi = self.x_domain.scale_range(x)
            label_x = viewport.padding[3]
            label_y = viewport.padding[0] + (
                (1.0 - x_hi) + (x_hi - x_lo) * 0.5
            ) * viewport.inner_height
            for n in range(n_series):
                y_min = self.y_domain.scale(ys[n][0])
                y_max = self.y_domain.scale(ys[n][1])
                dw = (y_max - y_min) * viewport.inner_width
                dh = (x_hi - x_lo) * viewport.inner_height
                dx = viewport.padding[3] + y_min * viewport.inner_width
                dy = viewport.padding[0] + (
                    1.0 - x_lo
                ) * viewport.inner_height - dh
                dy += dh * self.K_BAR_PADDING * 0.5
                dh *= 1.0 - self.K_BAR_PADDING
                if not self.stacked:
                    dh /= n_series
                    dy += dh * n + dh * self.K_BAR_PADDING_INNER * 0.5
                    dh *= 1.0 - self.K_BAR_PADDING_INNER
                target.draw_rect(
                    dx, dy, dw, dh,
                    self.series[n].prop("color"),
                    "bar", bar_label, self.series[n].name,
                )
                if dx + dw > label_x:
                    label_x = dx + dw
            if self.show_labels:
                target.draw_text(
                    bar_label, label_x + self.K_LABEL_PADDING, label_y,
                    "start", "central", "label",
                )


class Canvas:
    """reference: util/charts/canvas.cc"""

    # reference: canvas.h:45-56
    K_CHAR_WIDTH = 6
    K_LEGEND_LABEL_PADDING = 20
    K_LEGEND_LINE_HEIGHT = 20
    K_LEGEND_INSIDE_VERT_PADDING = 10
    K_LEGEND_OUTSIDE_VERT_PADDING = 10
    K_LEGEND_OUTSIDE_HORIZ_PADDING = 25
    K_LEGEND_POINT_WIDTH = 8
    K_LEGEND_POINT_SIZE = 3

    def __init__(self):
        self.width = 800
        self.height = 320
        self.title = ""
        self.subtitle = ""
        self.axes: List[AxisDefinition] = []
        self.charts: List[LineChart] = []
        self.grids: List[GridDefinition] = []
        self.legends: List[LegendDefinition] = []

    def render(self) -> str:
        # reference render order: title → outside legends → axes →
        # grids → inside legends → charts (canvas.cc:56-66)
        target = SVGTarget()
        viewport = Viewport(self.width, self.height)
        target.begin_chart(self.width, self.height, "fm-chart")
        self._render_title(target, viewport)
        self._render_outside_legends(target, viewport)
        self._render_axes(target, viewport)
        self._render_grids(target, viewport)
        self._render_inside_legends(target, viewport)
        for chart in self.charts:
            chart.render(target, viewport)
        target.finish_chart()
        return target.svg()

    def _estimate_text_length(self, s: str) -> int:
        return len(s) * self.K_CHAR_WIDTH  # canvas.h:134-136

    def _render_grids(self, target, viewport):
        # reference: Canvas::renderGrids (canvas.cc:708-745)
        for grid in self.grids:
            if grid.placement == GridDefinition.HORIZONTAL:
                target.begin_group("grid horizontal")
                for tick in grid.ticks():
                    line_y = viewport.padding[0] + viewport.inner_height * (
                        1.0 - tick
                    )
                    target.draw_line(
                        viewport.padding[3],
                        line_y,
                        viewport.padding[3] + viewport.inner_width,
                        line_y,
                        "gridline",
                    )
                target.finish_group()
            else:
                target.begin_group("grid vertical")
                for tick in grid.ticks():
                    line_x = viewport.padding[3] + viewport.inner_width * tick
                    target.draw_line(
                        line_x,
                        viewport.padding[0],
                        line_x,
                        viewport.padding[0] + viewport.inner_height,
                        "gridline",
                    )
                target.finish_group()

    def _render_outside_legends(self, target, viewport):
        # reference: Canvas::renderOutsideLegends (canvas.cc:439-508)
        for legend in self.legends:
            if legend.placement != "outside":
                continue
            target.begin_group("legend")
            bottom = legend.vert_pos == "bottom"
            if legend.horiz_pos == "left":
                self._render_left_legend(
                    target, viewport, legend,
                    self.K_LEGEND_OUTSIDE_HORIZ_PADDING, bottom, True,
                )
            else:
                self._render_right_legend(
                    target, viewport, legend,
                    self.K_LEGEND_OUTSIDE_HORIZ_PADDING, bottom, True,
                )
            if bottom:
                viewport.padding[2] += self.K_LEGEND_OUTSIDE_VERT_PADDING
            else:
                viewport.padding[0] += self.K_LEGEND_OUTSIDE_VERT_PADDING
            target.finish_group()

    def _render_inside_legends(self, target, viewport):
        # reference: Canvas::renderInsideLegends (canvas.cc:510-551)
        orig_padding = list(viewport.padding)
        for legend in self.legends:
            if legend.placement != "inside":
                continue
            target.begin_group("legend")
            viewport.padding[0] += self.K_LEGEND_INSIDE_VERT_PADDING
            viewport.padding[2] += self.K_LEGEND_INSIDE_VERT_PADDING
            bottom = legend.vert_pos == "bottom"
            if legend.horiz_pos == "left":
                self._render_left_legend(
                    target, viewport, legend,
                    self.K_LEGEND_OUTSIDE_HORIZ_PADDING, bottom, False,
                )
            else:
                self._render_right_legend(
                    target, viewport, legend,
                    self.K_LEGEND_OUTSIDE_HORIZ_PADDING, bottom, False,
                )
            target.finish_group()
        viewport.padding = orig_padding

    def _render_left_legend(
        self, target, viewport, legend, horiz_padding, bottom, outside
    ):
        # reference: Canvas::renderLeftLegend (canvas.cc:630-706)
        title = legend.title
        if bottom:
            height = (
                viewport.padding[0] + viewport.inner_height
                - self.K_LEGEND_LINE_HEIGHT * 0.5
            )
        else:
            height = viewport.padding[0]
        target.draw_text(
            title,
            viewport.padding[3] + viewport.inner_width - horiz_padding,
            height,
            "end",
            "text-after-edge" if bottom else "text-before-edge",
            "title",
        )
        lx = viewport.padding[3] + horiz_padding
        lx_boundary = (
            viewport.padding[3] + viewport.inner_width - horiz_padding
            - self._estimate_text_length(title)
            - self.K_LEGEND_LABEL_PADDING
        )
        for label, color, point_style in legend.entries:
            this_len = (
                self._estimate_text_length(label)
                + self.K_LEGEND_LABEL_PADDING
            )
            if lx + this_len > lx_boundary:  # line wrap
                lx = viewport.padding[3] + horiz_padding
                lx_boundary = (
                    viewport.padding[3] + viewport.inner_width - horiz_padding
                )
                height += (
                    -self.K_LEGEND_LINE_HEIGHT
                    if bottom
                    else self.K_LEGEND_LINE_HEIGHT
                )
            ly = (
                height - self.K_LEGEND_POINT_SIZE * 0.4
                if bottom
                else height + self.K_LEGEND_POINT_SIZE * 2.0
            )
            target.draw_point(
                lx, ly, point_style, self.K_LEGEND_POINT_SIZE, color,
                "point", "", "",
            )
            target.draw_text(
                label, lx + self.K_LEGEND_POINT_WIDTH, ly, "start",
                "central", "label",
            )
            lx += this_len
        if bottom:
            if outside:
                height -= self.K_LEGEND_LINE_HEIGHT
            viewport.padding[2] = (
                viewport.inner_height + viewport.padding[0]
                + viewport.padding[2] - height
            )
        else:
            height += self.K_LEGEND_LINE_HEIGHT
            viewport.padding[0] = height

    def _render_right_legend(
        self, target, viewport, legend, horiz_padding, bottom, outside
    ):
        # reference: Canvas::renderRightLegend (canvas.cc:553-628)
        title = legend.title
        if bottom:
            height = (
                viewport.padding[0] + viewport.inner_height
                - self.K_LEGEND_LINE_HEIGHT * 0.5
            )
        else:
            height = viewport.padding[0]
        target.draw_text(
            title,
            viewport.padding[3] + horiz_padding,
            height,
            "start",
            "text-after-edge" if bottom else "text-before-edge",
            "title",
        )
        lx = viewport.padding[3] + viewport.inner_width - horiz_padding
        lx_boundary = (
            viewport.padding[3] + horiz_padding
            + self._estimate_text_length(title)
            + self.K_LEGEND_LABEL_PADDING
        )
        for label, color, point_style in legend.entries:
            this_len = (
                self._estimate_text_length(label)
                + self.K_LEGEND_LABEL_PADDING
            )
            if lx - this_len < lx_boundary:  # line wrap
                lx = (
                    viewport.padding[3] + viewport.inner_width - horiz_padding
                )
                lx_boundary = viewport.padding[3] + horiz_padding
                height += (
                    -self.K_LEGEND_LINE_HEIGHT
                    if bottom
                    else self.K_LEGEND_LINE_HEIGHT
                )
            ly = (
                height - self.K_LEGEND_POINT_SIZE * 0.4
                if bottom
                else height + self.K_LEGEND_POINT_SIZE * 2.0
            )
            target.draw_point(
                lx, ly, point_style, self.K_LEGEND_POINT_SIZE, color,
                "point", "", "",
            )
            target.draw_text(
                label, lx - self.K_LEGEND_POINT_WIDTH, ly, "end",
                "central", "label",
            )
            lx -= this_len
        if bottom:
            if outside:
                height -= self.K_LEGEND_LINE_HEIGHT
            viewport.padding[2] = (
                viewport.inner_height + viewport.padding[0]
                + viewport.padding[2] - height
            )
        else:
            height += self.K_LEGEND_LINE_HEIGHT
            viewport.padding[0] = height

    def _render_title(self, target, viewport):
        if self.title:
            target.draw_text(
                self.title,
                viewport.padding[3] + viewport.inner_width * 0.5,
                viewport.padding[0],
                "middle",
                "text-before-edge",
                "chart-title",
            )
            viewport.padding[0] += K_TITLE_LINE_HEIGHT
        if self.subtitle:
            target.draw_text(
                self.subtitle,
                viewport.padding[3] + viewport.inner_width * 0.5,
                viewport.padding[0],
                "middle",
                "text-before-edge",
                "chart-subtitle",
            )
            viewport.padding[0] += K_SUBTITLE_LINE_HEIGHT

    def _render_axes(self, target, viewport):
        # reference: Canvas::renderAxes (canvas.cc:95-180) — integer math
        padding = list(viewport.padding)
        placements = {"top": [], "right": [], "bottom": [], "left": []}
        pad_idx = {"top": 0, "right": 1, "bottom": 2, "left": 3}
        for axis in self.axes:
            i = pad_idx[axis.position]
            placements[axis.position].append((padding[i], axis))
            padding[i] += K_AXIS_PADDING
            padding[i] += K_AXIS_LABEL_HEIGHT if (
                axis.position in ("top", "bottom") and axis.has_labels()
            ) else 0
            padding[i] += K_AXIS_LABEL_WIDTH if (
                axis.position in ("left", "right") and axis.has_labels()
            ) else 0
            padding[i] += K_AXIS_TITLE_LENGTH if axis.has_title() else 0

        if padding[0] < K_AXIS_LABEL_HEIGHT * 0.5:
            padding[0] += int(K_AXIS_LABEL_HEIGHT * 0.5)
        if padding[1] < K_AXIS_LABEL_WIDTH * 0.5:
            padding[1] += int(K_AXIS_LABEL_WIDTH * 0.5)
        if padding[2] < K_AXIS_LABEL_HEIGHT * 0.5:
            padding[2] += int(K_AXIS_LABEL_HEIGHT * 0.5)
        if padding[3] < K_AXIS_LABEL_WIDTH * 0.5:
            padding[3] += int(K_AXIS_LABEL_WIDTH * 0.5)

        viewport.padding = padding

        for offset, axis in placements["top"]:
            self._render_top_axis(target, viewport, axis, offset)
        for offset, axis in placements["right"]:
            self._render_right_axis(target, viewport, axis, offset)
        for offset, axis in placements["bottom"]:
            self._render_bottom_axis(target, viewport, axis, offset)
        for offset, axis in placements["left"]:
            self._render_left_axis(target, viewport, axis, offset)

    def _render_bottom_axis(self, target, viewport, axis, bottom):
        padding_left = viewport.padding[3]
        inner_width = viewport.inner_width
        bottom += K_AXIS_PADDING
        target.begin_group("axis bottom")
        if axis.has_title():
            target.draw_text(
                axis.title,
                padding_left + inner_width * 0.5,
                self.height - bottom,
                "middle",
                "no-change",
                "title",
            )
            bottom += K_AXIS_TITLE_LENGTH
        if axis.has_labels():
            bottom += K_AXIS_LABEL_HEIGHT
            for pos, text in axis.get_labels():
                tick_x = padding_left + inner_width * pos
                target.draw_text(
                    text,
                    tick_x,
                    self.height - bottom + K_AXIS_LABEL_HEIGHT * 0.5,
                    "middle",
                    "central",
                    "label",
                )
        for tick in axis.get_ticks():
            tick_x = padding_left + inner_width * tick
            target.draw_line(
                tick_x,
                self.height - bottom,
                tick_x,
                self.height - bottom - K_TICK_LENGTH,
                "tick",
            )
        target.draw_line(
            padding_left,
            self.height - bottom,
            padding_left + inner_width,
            self.height - bottom,
            "stroke",
        )
        target.finish_group()

    def _render_top_axis(self, target, viewport, axis, top):
        padding_left = viewport.padding[3]
        inner_width = viewport.inner_width
        top += K_AXIS_PADDING
        target.begin_group("axis bottom")  # reference quirk: class is 'axis bottom'
        if axis.has_title():
            target.draw_text(
                axis.title,
                padding_left + inner_width * 0.5,
                top,
                "middle",
                "text-before-edge",
                "title",
            )
            top += K_AXIS_TITLE_LENGTH
        if axis.has_labels():
            top += K_AXIS_LABEL_HEIGHT
            for pos, text in axis.get_labels():
                tick_x = padding_left + inner_width * pos
                target.draw_text(
                    text,
                    tick_x,
                    top - K_AXIS_LABEL_HEIGHT * 0.5,
                    "middle",
                    "central",
                    "label",
                )
        for tick in axis.get_ticks():
            tick_x = padding_left + inner_width * tick
            target.draw_line(tick_x, top, tick_x, top + K_TICK_LENGTH, "tick")
        target.draw_line(
            padding_left, top, padding_left + inner_width, top, "stroke"
        )
        target.finish_group()

    def _render_left_axis(self, target, viewport, axis, left):
        padding_top = viewport.padding[0]
        inner_height = viewport.inner_height
        left += K_AXIS_PADDING
        target.begin_group("axis left")
        if axis.has_title():
            target.draw_text(
                axis.title,
                left,
                padding_top + inner_height * 0.5,
                "middle",
                "text-before-edge",
                "title",
                270,
            )
            left += K_AXIS_TITLE_LENGTH
        if axis.has_labels():
            left += K_AXIS_LABEL_WIDTH
            for pos, text in axis.get_labels():
                tick_y = padding_top + inner_height * (1.0 - pos)
                target.draw_text(
                    text,
                    left - (K_TICK_LENGTH * 2),
                    tick_y,
                    "end",
                    "middle",
                    "label",
                )
        for tick in axis.get_ticks():
            tick_y = padding_top + inner_height * (1.0 - tick)
            target.draw_line(
                left, tick_y, left + K_TICK_LENGTH, tick_y, "tick"
            )
        target.draw_line(
            left, padding_top, left, padding_top + inner_height, "stroke"
        )
        target.finish_group()

    def _render_right_axis(self, target, viewport, axis, right):
        padding_top = viewport.padding[0]
        inner_height = viewport.inner_height
        right += K_AXIS_PADDING
        target.begin_group("axis right")
        if axis.has_title():
            right += K_AXIS_TITLE_LENGTH
            target.draw_text(
                axis.title,
                self.width - right,
                padding_top + inner_height * 0.5,
                "middle",
                "text-before-edge",
                "title",
                270,
            )
        if axis.has_labels():
            right += K_AXIS_LABEL_WIDTH
            for pos, text in axis.get_labels():
                tick_y = padding_top + inner_height * (1.0 - pos)
                target.draw_text(
                    text,
                    self.width - right + (K_TICK_LENGTH * 2),
                    tick_y,
                    "start",
                    "middle",
                    "label",
                )
        for tick in axis.get_ticks():
            tick_y = padding_top + inner_height * (1.0 - tick)
            target.draw_line(
                self.width - right,
                tick_y,
                self.width - right - K_TICK_LENGTH,
                tick_y,
                "tick",
            )
        target.draw_line(
            self.width - right,
            padding_top,
            self.width - right,
            padding_top + inner_height,
            "stroke",
        )
        target.finish_group()


# ---------------------------------------------------------------------------
# ChartSQL glue (reference: sql/extensions/chartsql/chartbuilder.h)
# ---------------------------------------------------------------------------

_CHART_TYPES = {
    "T_LINECHART": LineChart,
    "T_POINTCHART": PointChart,
    "T_AREACHART": AreaChart,
    "T_BARCHART": BarChart,
}


def render_chart(node, txn) -> bytes:
    from eventql_tpu_torch.exec.operators import execute_node

    canvas = Canvas()
    cls = _CHART_TYPES.get(node.chart_type)
    if cls is None:
        raise RuntimeError_(f"unsupported chart type: {node.chart_type}")
    chart = cls()

    for query in node.union_queries:
        rel = execute_node(query, txn)
        _add_series_from_relation(chart, query, rel)

    canvas.charts.append(chart)

    # chart-level properties first (reference applies them in the chart
    # builder, before axes: chart_expression.cc:71-99)
    for prop in node.properties:
        if prop.ntype == "T_DOMAIN" and prop.token is not None:
            _apply_domain_definition(chart, prop)
            continue
        if prop.ntype != "T_PROPERTY" or prop.token is None:
            continue
        ttype = prop.token.ttype
        if ttype == "T_ORIENTATION" and isinstance(chart, BarChart):
            val = prop.children[0].token if prop.children else None
            if val is not None:
                chart.set_orientation(
                    "horizontal" if val.ttype == "T_HORIZONTAL" else "vertical"
                )
        elif ttype == "T_STACKED" and isinstance(chart, BarChart):
            chart.set_stacked(True)
        elif ttype == "T_LABELS" and isinstance(chart, BarChart):
            chart.set_labels(True)

    # apply DRAW properties (axes, titles) from the AST
    for prop in node.properties:
        if prop.ntype == "T_AXIS":
            pos_tok = prop.children[0].token.ttype if prop.children else None
            pos = {
                "T_TOP": AxisDefinition.TOP,
                "T_RIGHT": AxisDefinition.RIGHT,
                "T_BOTTOM": AxisDefinition.BOTTOM,
                "T_LEFT": AxisDefinition.LEFT,
            }.get(pos_tok)
            if pos is None:
                raise RuntimeError_("corrupt AST: invalid axis position")
            axis = AxisDefinition(pos, chart.domain_for_axis(pos))
            for child in prop.children[1:]:
                if child.ntype == "T_PROPERTY" and child.token and child.token.ttype == "T_TITLE":
                    lit = child.children[0]
                    axis.title = lit.token.value if lit.token else ""
            canvas.axes.append(axis)
        elif prop.ntype == "T_GRID":
            # reference: ChartExpression::applyGrid → chart->addGrid
            for child in prop.children:
                if child.ntype == "T_PROPERTY" and child.token:
                    placement = (
                        GridDefinition.HORIZONTAL
                        if child.token.ttype == "T_HORIZONTAL"
                        else GridDefinition.VERTICAL
                    )
                    canvas.grids.append(
                        GridDefinition(
                            placement, chart.grid_domain(placement)
                        )
                    )
        elif prop.ntype == "T_LEGEND":
            # reference: ChartExpression::applyLegend
            # (chart_expression.cc:349-416; defaults bottom/left/outside)
            vert, horiz, placement, title = "bottom", "left", "outside", ""
            for child in prop.children:
                ttype = child.token.ttype if child.token else None
                if ttype == "T_TOP":
                    vert = "top"
                elif ttype == "T_BOTTOM":
                    vert = "bottom"
                elif ttype == "T_LEFT":
                    horiz = "left"
                elif ttype == "T_RIGHT":
                    horiz = "right"
                elif ttype == "T_INSIDE":
                    placement = "inside"
                elif ttype == "T_OUTSIDE":
                    placement = "outside"
                elif ttype == "T_TITLE" and child.children:
                    lit = child.children[0]
                    title = lit.token.value if lit.token else ""
            legend = LegendDefinition(vert, horiz, placement, title)
            # Drawable::updateLegend: one entry per series
            # (drawable.cc:57-72)
            for s in chart.series:
                legend.add_entry(
                    s.name, s.properties.get("color", ""), "circle"
                )
            canvas.legends.append(legend)
        elif prop.ntype == "T_PROPERTY" and prop.token:
            if prop.token.ttype == "T_TITLE" and prop.children:
                canvas.title = prop.children[0].token.value
            elif prop.token.ttype == "T_SUBTITLE" and prop.children:
                canvas.subtitle = prop.children[0].token.value

    return canvas.render().encode("utf-8")


def _eval_const_ast(ast):
    """Evaluate a constant value-expression AST (reference:
    Runtime::evaluateConstExpression, used by applyDomainDefinitions)."""
    from eventql_tpu_torch.plan.builder import QueryPlanBuilder, _empty_resolver
    from eventql_tpu_torch.plan.scalar_eval import evaluate_scalar
    from eventql_tpu_torch.plan.functions import DEFAULT_REGISTRY

    builder = QueryPlanBuilder(DEFAULT_REGISTRY)
    expr = builder.build_value_expression(ast, _empty_resolver)
    return evaluate_scalar(expr)


def _apply_domain_definition(chart, prop):
    """XDOMAIN/YDOMAIN [min, max] [INVERT] [LOGARITHMIC] (reference:
    ChartExpression::applyDomainDefinitions + DomainConfig,
    chart_expression.cc:199-270, domainconfig.cc:36-113)."""
    dim = {
        "T_XDOMAIN": "x",
        "T_YDOMAIN": "y",
        "T_ZDOMAIN": "z",
    }.get(prop.token.ttype)
    if dim is None:
        raise RuntimeError_("corrupt AST: DOMAIN has invalid token")
    domain = chart.get_domain(dim)
    for child in prop.children:
        if child.ntype == "T_DOMAIN_SCALE" and len(child.children) == 2:
            lo = _eval_const_ast(child.children[0]).payload()
            hi = _eval_const_ast(child.children[1]).payload()
            if not hasattr(domain, "set_min"):
                raise RuntimeError_(
                    f"TypeError: can't set min value for {dim} domain"
                )
            domain.set_min(float(lo))
            domain.set_max(float(hi))
        elif child.ntype == "T_PROPERTY" and child.token is not None:
            if child.token.ttype == "T_INVERT":
                domain.set_inverted(True)
            elif child.token.ttype == "T_LOGARITHMIC":
                if not hasattr(domain, "set_logarithmic"):
                    raise RuntimeError_(
                        "TypeError: can't set LOGARITHMIC for discrete"
                        f" domain {dim}"
                    )
                domain.set_logarithmic(True)


def _add_series_from_relation(chart, query, rel):
    """Map result columns series/x/y into chart series
    (reference: chartbuilder.h:49-143)."""
    names = {n: i for i, n in enumerate(rel.names)}

    def col_index(*cands):
        for c in cands:
            if c in names:
                return names[c]
        return None

    name_ind = col_index("series")
    x_ind = col_index("x", "X")
    y_ind = col_index("y", "Y")
    if x_ind is None:
        raise RuntimeError_("can't draw SELECT because it has no 'x' column")
    if y_ind is None:
        raise RuntimeError_("can't draw SELECT because it has no 'y' column")

    x_col = rel.columns[x_ind]
    y_col = rel.columns[y_ind]
    x_is_time = x_col.stype in (
        SType.TIMESTAMP64,
        SType.UINT64,
        SType.INT64,
        SType.FLOAT64,
    )

    series_map: Dict[str, Series] = {}
    order: List[str] = []
    for i in range(rel.num_rows):
        sname = (
            rel.columns[name_ind].value_at(i).to_string()
            if name_ind is not None
            else ""
        )
        if sname not in series_map:
            series_map[sname] = Series(sname)
            order.append(sname)
        xv = x_col.value_at(i)
        yv = y_col.value_at(i)
        x_payload = xv.payload()
        y_payload = float(yv.payload() if yv.stype != SType.STRING else 0)
        if x_is_time:
            # label via UnixTime::toString + double toString
            # (reference: Series2D::labelFor, series.h:199-205)
            label = "%s: %s" % (
                format_timestamp(int(x_payload)),
                _double_to_string(y_payload),
            )
            x_val = int(x_payload)
        else:
            label = "%s: %s" % (
                xv.to_string(),
                _double_to_string(y_payload),
            )
            x_val = x_payload
        series_map[sname].points.append((x_val, y_payload, label))

    for sname in order:
        chart.add_series(series_map[sname], x_is_time)
