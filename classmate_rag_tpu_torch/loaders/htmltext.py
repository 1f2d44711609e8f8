"""HTML → text extraction on the stdlib HTMLParser.

The reference leans on readability-lxml + BeautifulSoup
(rag/loaders/html_readable.py:37-50); neither is guaranteed in this
environment, so this is a dependency-free extractor with a light
"main content" heuristic: boilerplate containers (nav/header/footer/aside)
and non-content tags (script/style/noscript/template) are dropped, block
tags emit newlines, and blank lines are collapsed.

Host copy of the JAX package's ``loaders/htmltext.py`` (no JAX).
"""

from __future__ import annotations

from html import unescape
from html.parser import HTMLParser
from typing import List

_SKIP_SUBTREES = {"script", "style", "noscript", "template", "svg", "head"}
_BOILERPLATE = {"nav", "header", "footer", "aside"}
_BLOCK_TAGS = {
    "p", "div", "br", "li", "ul", "ol", "table", "tr", "td", "th",
    "h1", "h2", "h3", "h4", "h5", "h6", "blockquote", "pre", "section",
    "article", "figure", "figcaption", "dt", "dd", "hr",
}


class _TextExtractor(HTMLParser):
    def __init__(self, drop_boilerplate: bool = True) -> None:
        super().__init__(convert_charrefs=True)
        self._skip_depth = 0
        self._drop_boilerplate = drop_boilerplate
        self._parts: List[str] = []

    def handle_starttag(self, tag: str, attrs) -> None:
        if tag in _SKIP_SUBTREES or (self._drop_boilerplate and tag in _BOILERPLATE):
            self._skip_depth += 1
        elif self._skip_depth == 0 and tag in _BLOCK_TAGS:
            self._parts.append("\n")

    def handle_endtag(self, tag: str) -> None:
        if tag in _SKIP_SUBTREES or (self._drop_boilerplate and tag in _BOILERPLATE):
            if self._skip_depth > 0:
                self._skip_depth -= 1
        elif self._skip_depth == 0 and tag in _BLOCK_TAGS:
            self._parts.append("\n")

    def handle_data(self, data: str) -> None:
        if self._skip_depth == 0 and data:
            self._parts.append(data)

    def text(self) -> str:
        raw = "".join(self._parts)
        lines = [ln.strip() for ln in raw.splitlines()]
        return "\n".join(ln for ln in lines if ln)


def html_to_text(html: str | bytes, *, drop_boilerplate: bool = True) -> str:
    """Extract readable text from an HTML document or fragment."""
    if isinstance(html, bytes):
        html = html.decode("utf-8", errors="ignore")
    parser = _TextExtractor(drop_boilerplate=drop_boilerplate)
    try:
        parser.feed(unescape_preserving(html))
        parser.close()
    except Exception:
        pass
    return parser.text()


def unescape_preserving(html: str) -> str:
    # HTMLParser(convert_charrefs=True) already unescapes character refs in
    # data; pre-unescaping would double-decode (&amp;lt; -> <). Pass through.
    return html


def html_title(html: str | bytes) -> str:
    """Best-effort <title> text."""
    if isinstance(html, bytes):
        html = html.decode("utf-8", errors="ignore")
    low = html.lower()
    start = low.find("<title")
    if start < 0:
        return ""
    gt = low.find(">", start)
    end = low.find("</title>", start)
    if gt < 0 or end < 0 or end <= gt:
        return ""
    return unescape(html[gt + 1 : end]).strip()
