"""From-scratch PDF text extraction (stdlib only).

pypdf is not available in this environment, so this module implements the
subset of PDF needed to extract text from digitally-generated documents
(the reference delegates to pypdf, rag/loaders/__init__.py:89-102):

- indirect-object scanning (no reliance on the xref table, which tolerates
  mildly damaged files), including /ObjStm object streams;
- stream decoding: FlateDecode (+ PNG predictors), ASCIIHexDecode,
  ASCII85Decode;
- page-tree traversal from the document catalog for correct page order;
- a content-stream interpreter for the text operators (BT/ET, Tj, TJ, ', ",
  Td/TD/T*/Tm, Tf) with newline heuristics on text-line moves;
- per-font decoding via /ToUnicode CMaps (bfchar/bfrange) with a
  single-byte Latin-1 fallback, and 2-byte code handling for Type0 fonts.

The ``enable_ocr`` flag is honored (the reference's flag was dead — it
flowed into a loader that ignored it, see SURVEY §2.4.3): when set and a
page yields no text, we attempt OCR via pytesseract+pdf2image if importable,
and otherwise record a warning instead of silently dropping the page.

Host copy of the JAX package's ``loaders/pdf.py`` (no JAX).
"""

from __future__ import annotations

import base64
import logging
import re
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

Pages = List[Tuple[int, str]]


# ---------------------------------------------------------------------------
# Low-level object model
# ---------------------------------------------------------------------------

class Ref:
    __slots__ = ("num",)

    def __init__(self, num: int) -> None:
        self.num = num

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Ref({self.num})"


class Name(str):
    """A PDF name token (distinct from a PDF string)."""


class Keyword(bytes):
    """A bare keyword/operator token (distinct from a PDF string)."""


_WHITESPACE = b"\x00\t\n\x0c\r "
_DELIMS = b"()<>[]{}/%"


class _Lexer:
    """Tokenizer over a PDF object/content byte buffer."""

    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos
        self.n = len(data)

    def _skip_ws(self) -> None:
        d, n = self.data, self.n
        while self.pos < n:
            c = d[self.pos]
            if c in _WHITESPACE:
                self.pos += 1
            elif c == 0x25:  # '%' comment
                while self.pos < n and d[self.pos] not in (0x0A, 0x0D):
                    self.pos += 1
            else:
                return

    def peek_bytes(self, k: int) -> bytes:
        return self.data[self.pos : self.pos + k]

    def read_token(self) -> Optional[bytes]:
        """Next raw token: delimiters, numbers, names, or keywords."""
        self._skip_ws()
        if self.pos >= self.n:
            return None
        d = self.data
        c = d[self.pos]
        if c == 0x3C:  # '<'
            if self.pos + 1 < self.n and d[self.pos + 1] == 0x3C:
                self.pos += 2
                return b"<<"
            self.pos += 1
            return b"<"
        if c == 0x3E:  # '>'
            if self.pos + 1 < self.n and d[self.pos + 1] == 0x3E:
                self.pos += 2
                return b">>"
            self.pos += 1
            return b">"
        if c in b"[]{}()/":
            self.pos += 1
            return bytes([c])
        start = self.pos
        while self.pos < self.n and d[self.pos] not in _WHITESPACE and d[self.pos] not in _DELIMS:
            self.pos += 1
        return d[start : self.pos]


def _parse_literal_string(lex: _Lexer) -> bytes:
    """Parse after '(' up to the balanced ')'. Handles escapes."""
    out = bytearray()
    depth = 1
    d = lex.data
    while lex.pos < lex.n:
        c = d[lex.pos]
        lex.pos += 1
        if c == 0x5C:  # backslash
            if lex.pos >= lex.n:
                break
            e = d[lex.pos]
            lex.pos += 1
            if e == ord("n"):
                out.append(0x0A)
            elif e == ord("r"):
                out.append(0x0D)
            elif e == ord("t"):
                out.append(0x09)
            elif e == ord("b"):
                out.append(0x08)
            elif e == ord("f"):
                out.append(0x0C)
            elif e in b"()\\":
                out.append(e)
            elif 0x30 <= e <= 0x37:  # octal escape, up to 3 digits
                oct_digits = [e]
                for _ in range(2):
                    if lex.pos < lex.n and 0x30 <= d[lex.pos] <= 0x37:
                        oct_digits.append(d[lex.pos])
                        lex.pos += 1
                    else:
                        break
                out.append(int(bytes(oct_digits), 8) & 0xFF)
            elif e in (0x0A, 0x0D):  # line continuation
                if e == 0x0D and lex.pos < lex.n and d[lex.pos] == 0x0A:
                    lex.pos += 1
            else:
                out.append(e)
        elif c == 0x28:  # '('
            depth += 1
            out.append(c)
        elif c == 0x29:  # ')'
            depth -= 1
            if depth == 0:
                break
            out.append(c)
        else:
            out.append(c)
    return bytes(out)


def _parse_hex_string(lex: _Lexer) -> bytes:
    d = lex.data
    start = lex.pos
    end = d.find(b">", start)
    if end < 0:
        end = lex.n
    hex_bytes = re.sub(rb"[^0-9A-Fa-f]", b"", d[start:end])
    lex.pos = end + 1
    if len(hex_bytes) % 2:
        hex_bytes += b"0"
    try:
        return bytes.fromhex(hex_bytes.decode("ascii"))
    except ValueError:
        return b""


_NUM_RE = re.compile(rb"^[+-]?(\d+\.?\d*|\.\d+)$")


def parse_object(lex: _Lexer):
    """Recursive-descent parse of one PDF object at the lexer position."""
    tok = lex.read_token()
    if tok is None:
        return None
    if tok == b"<<":
        obj: Dict[str, object] = {}
        while True:
            save = lex.pos
            t = lex.read_token()
            if t is None or t == b">>":
                break
            if t != b"/":
                lex.pos = save
                # tolerate junk; try parsing and discarding one object
                if parse_object(lex) is None:
                    break
                continue
            key_tok = lex.read_token()
            key = key_tok.decode("latin-1") if key_tok else ""
            obj[key] = parse_object(lex)
        return obj
    if tok == b"[":
        arr: List[object] = []
        while True:
            save = lex.pos
            t = lex.read_token()
            if t is None or t == b"]":
                break
            lex.pos = save
            arr.append(parse_object(lex))
        return arr
    if tok == b"(":
        return _parse_literal_string(lex)
    if tok == b"<":
        return _parse_hex_string(lex)
    if tok == b"/":
        t = lex.read_token()
        return Name(t.decode("latin-1")) if t else Name("")
    if tok == b"true":
        return True
    if tok == b"false":
        return False
    if tok == b"null":
        return None
    if _NUM_RE.match(tok):
        # Might be the start of "num gen R" (an indirect reference).
        save = lex.pos
        t2 = lex.read_token()
        if t2 is not None and _NUM_RE.match(t2) and b"." not in t2:
            t3 = lex.read_token()
            if t3 == b"R":
                return Ref(int(tok))
            lex.pos = save
        else:
            lex.pos = save
        if b"." in tok:
            return float(tok)
        return int(tok)
    return Keyword(tok)  # bare keyword (operator in content streams)


# ---------------------------------------------------------------------------
# Stream filters
# ---------------------------------------------------------------------------

def _png_unpredict(data: bytes, colors: int, columns: int, bpc: int) -> bytes:
    row_len = max(1, (colors * bpc * columns + 7) // 8)
    stride = row_len + 1
    out = bytearray()
    prev = bytearray(row_len)
    bpp = max(1, (colors * bpc + 7) // 8)
    for off in range(0, len(data) - row_len, stride):
        ftype = data[off]
        row = bytearray(data[off + 1 : off + 1 + row_len])
        if ftype == 1:  # Sub
            for i in range(bpp, row_len):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            for i in range(row_len):
                row[i] = (row[i] + prev[i]) & 0xFF
        elif ftype == 3:  # Average
            for i in range(row_len):
                left = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(row_len):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
        out.extend(row)
        prev = row
    return bytes(out)


def decode_stream(raw: bytes, sdict: Dict[str, object], resolve) -> bytes:
    filters = resolve(sdict.get("Filter"))
    if filters is None:
        return raw
    if not isinstance(filters, list):
        filters = [filters]
    parms_obj = resolve(sdict.get("DecodeParms")) or resolve(sdict.get("DP"))
    if not isinstance(parms_obj, list):
        parms_obj = [parms_obj] * len(filters)

    data = raw
    for filt, parms in zip(filters, parms_obj):
        fname = str(resolve(filt) or "")
        parms = resolve(parms) or {}
        if fname in ("FlateDecode", "Fl"):
            try:
                data = zlib.decompress(data)
            except zlib.error:
                try:
                    data = zlib.decompressobj().decompress(data)
                except zlib.error:
                    return b""
            pred = int(resolve(parms.get("Predictor")) or 1) if isinstance(parms, dict) else 1
            if pred >= 10:
                colors = int(resolve(parms.get("Colors")) or 1)
                columns = int(resolve(parms.get("Columns")) or 1)
                bpc = int(resolve(parms.get("BitsPerComponent")) or 8)
                data = _png_unpredict(data, colors, columns, bpc)
        elif fname in ("ASCIIHexDecode", "AHx"):
            hex_part = data.split(b">")[0]
            clean = re.sub(rb"[^0-9A-Fa-f]", b"", hex_part)
            if len(clean) % 2:
                clean += b"0"
            data = bytes.fromhex(clean.decode("ascii"))
        elif fname in ("ASCII85Decode", "A85"):
            body = data.strip()
            if body.startswith(b"<~"):
                body = body[2:]
            if body.endswith(b"~>"):
                body = body[:-2]
            try:
                data = base64.a85decode(body)
            except ValueError:
                return b""
        else:
            # Unsupported (DCT/JPX/LZW/image filters): not text-bearing.
            return b""
    return data


# ---------------------------------------------------------------------------
# Document parsing
# ---------------------------------------------------------------------------

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b")


class PdfDocument:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.objects: Dict[int, object] = {}
        self.streams: Dict[int, bytes] = {}
        self._scan_objects()
        self._expand_object_streams()

    # -- object table -------------------------------------------------

    def _scan_objects(self) -> None:
        data = self.data
        for m in _OBJ_RE.finditer(data):
            num = int(m.group(1))
            lex = _Lexer(data, m.end())
            try:
                obj = parse_object(lex)
            except Exception:
                continue
            self.objects[num] = obj
            # Stream payload?
            save = lex.pos
            tok = lex.read_token()
            if tok == b"stream":
                # EOL after 'stream' keyword: CRLF or LF
                p = lex.pos
                if data[p : p + 2] == b"\r\n":
                    p += 2
                elif data[p : p + 1] in (b"\n", b"\r"):
                    p += 1
                length = None
                if isinstance(obj, dict):
                    length = self._resolve_early(obj.get("Length"))
                trust_length = False
                if isinstance(length, int) and 0 <= length <= len(data) - p:
                    end = p + length
                    # Validate: 'endstream' should follow soon after.
                    tail = data[end : end + 20]
                    trust_length = b"endstream" in tail
                    if not trust_length:
                        end = data.find(b"endstream", p)
                else:
                    end = data.find(b"endstream", p)
                if end < 0:
                    end = len(data)
                payload = data[p:end]
                if not trust_length:
                    # Without a trusted /Length the EOL before 'endstream'
                    # is included in the slice; strip it. With a trusted
                    # Length the payload is exact — trailing 0x0A/0x0D are
                    # real data bytes (e.g. a deflate tail) and must stay.
                    payload = payload.rstrip(b"\r\n")
                self.streams[num] = payload
            else:
                lex.pos = save

    def _resolve_early(self, obj):
        """Resolve /Length refs during scanning (target may appear later)."""
        if isinstance(obj, Ref):
            target = self.objects.get(obj.num)
            if target is None:
                m = re.search(
                    rb"(?m)^\s*%d\s+\d+\s+obj\b" % obj.num, self.data
                )
                if m:
                    lex = _Lexer(self.data, m.end())
                    try:
                        target = parse_object(lex)
                    except Exception:
                        target = None
            return target
        return obj

    def resolve(self, obj):
        seen = 0
        while isinstance(obj, Ref) and seen < 32:
            obj = self.objects.get(obj.num)
            seen += 1
        return obj

    def stream_bytes(self, num: int) -> bytes:
        sdict = self.objects.get(num)
        raw = self.streams.get(num, b"")
        if not isinstance(sdict, dict):
            return b""
        return decode_stream(raw, sdict, self.resolve)

    def _expand_object_streams(self) -> None:
        for num, obj in list(self.objects.items()):
            if not (isinstance(obj, dict) and str(obj.get("Type")) == "ObjStm"):
                continue
            payload = self.stream_bytes(num)
            if not payload:
                continue
            n_objs = int(self.resolve(obj.get("N")) or 0)
            first = int(self.resolve(obj.get("First")) or 0)
            header = payload[:first].split()
            pairs = []
            for i in range(0, min(len(header), 2 * n_objs) - 1, 2):
                try:
                    pairs.append((int(header[i]), int(header[i + 1])))
                except ValueError:
                    break
            for obj_num, offset in pairs:
                if obj_num in self.objects:
                    continue
                lex = _Lexer(payload, first + offset)
                try:
                    self.objects[obj_num] = parse_object(lex)
                except Exception:
                    continue

    # -- page tree ------------------------------------------------------

    def pages(self) -> List[Dict[str, object]]:
        catalog = None
        for obj in self.objects.values():
            obj = self.resolve(obj)
            if isinstance(obj, dict) and str(obj.get("Type")) == "Catalog":
                catalog = obj
                break
        ordered: List[Dict[str, object]] = []
        visited = set()

        def walk(node_ref) -> None:
            node = self.resolve(node_ref)
            if not isinstance(node, dict):
                return
            ident = id(node)
            if ident in visited:
                return
            visited.add(ident)
            node_type = str(node.get("Type"))
            if node_type == "Page":
                ordered.append(node)
            else:
                for kid in self.resolve(node.get("Kids")) or []:
                    walk(kid)

        if catalog is not None:
            walk(catalog.get("Pages"))
        if not ordered:  # damaged tree: fall back to object order
            for num in sorted(self.objects):
                obj = self.resolve(self.objects[num])
                if isinstance(obj, dict) and str(obj.get("Type")) == "Page":
                    ordered.append(obj)
        return ordered

    def page_content(self, page: Dict[str, object]) -> bytes:
        contents = self.resolve(page.get("Contents"))
        refs: List[Ref] = []
        raw_contents = page.get("Contents")
        if isinstance(raw_contents, Ref):
            refs = [raw_contents]
        elif isinstance(contents, list):
            refs = [c for c in contents if isinstance(c, Ref)]
        parts: List[bytes] = []
        for ref in refs:
            parts.append(self.stream_bytes(ref.num))
        return b"\n".join(p for p in parts if p)

    def page_fonts(self, page: Dict[str, object]) -> Dict[str, "FontDecoder"]:
        res = self.resolve(page.get("Resources")) or {}
        fonts_dict = self.resolve(res.get("Font")) if isinstance(res, dict) else None
        out: Dict[str, FontDecoder] = {}
        if not isinstance(fonts_dict, dict):
            return out
        for fname, fref in fonts_dict.items():
            font = self.resolve(fref)
            if isinstance(font, dict):
                out[fname] = FontDecoder(self, font)
        return out


# ---------------------------------------------------------------------------
# Font decoding
# ---------------------------------------------------------------------------

_BFCHAR_RE = re.compile(rb"beginbfchar(.*?)endbfchar", re.DOTALL)
_BFRANGE_RE = re.compile(rb"beginbfrange(.*?)endbfrange", re.DOTALL)
_CODESPACE_RE = re.compile(
    rb"begincodespacerange(.*?)endcodespacerange", re.DOTALL
)
_HEX_TOKEN_RE = re.compile(rb"<([0-9A-Fa-f]+)>")


def _utf16be_to_text(hexstr: bytes) -> str:
    try:
        raw = bytes.fromhex(hexstr.decode("ascii"))
        if len(raw) % 2:
            raw += b"\x00"
        return raw.decode("utf-16-be", errors="ignore")
    except (ValueError, UnicodeDecodeError):
        return ""


class FontDecoder:
    """Decodes PDF string bytes to unicode for one font resource."""

    def __init__(self, doc: PdfDocument, font: Dict[str, object]) -> None:
        self.code_len = 2 if str(doc.resolve(font.get("Subtype"))) == "Type0" else 1
        self.cmap: Dict[int, str] = {}
        to_uni = font.get("ToUnicode")
        if isinstance(to_uni, Ref):
            self._parse_cmap(doc.stream_bytes(to_uni.num))

    def _parse_cmap(self, data: bytes) -> None:
        if not data:
            return
        # The codespacerange is authoritative for the code byte width —
        # a Type0 font can still declare a 1-byte codespace.
        for m in _CODESPACE_RE.finditer(data):
            bounds = _HEX_TOKEN_RE.findall(m.group(1))
            if bounds:
                self.code_len = max(1, len(bounds[0]) // 2)
                break
        for m in _BFCHAR_RE.finditer(data):
            toks = _HEX_TOKEN_RE.findall(m.group(1))
            for i in range(0, len(toks) - 1, 2):
                src = int(toks[i], 16)
                self.cmap[src] = _utf16be_to_text(toks[i + 1])
                if len(toks[i]) > 2:
                    self.code_len = max(self.code_len, len(toks[i]) // 2)
        for m in _BFRANGE_RE.finditer(data):
            body = m.group(1)
            # Two forms: <lo> <hi> <dst>  |  <lo> <hi> [<d1> <d2> ...]
            pos = 0
            while True:
                mm = re.match(
                    rb"\s*<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*", body[pos:]
                )
                if not mm:
                    break
                lo = int(mm.group(1), 16)
                hi = int(mm.group(2), 16)
                if len(mm.group(1)) > 2:
                    self.code_len = max(self.code_len, len(mm.group(1)) // 2)
                pos += mm.end()
                if pos < len(body) and body[pos : pos + 1] == b"[":
                    end = body.find(b"]", pos)
                    if end < 0:
                        # Truncated array form (no closing ']'): take
                        # what's there and stop — 'pos = end + 1' would
                        # reset to 0 and loop forever on this range.
                        end = len(body)
                    dsts = _HEX_TOKEN_RE.findall(body[pos:end])
                    for i, dst in enumerate(dsts):
                        self.cmap[lo + i] = _utf16be_to_text(dst)
                    pos = end + 1
                    if pos >= len(body):
                        break
                else:
                    mm2 = re.match(rb"<([0-9A-Fa-f]+)>\s*", body[pos:])
                    if not mm2:
                        break
                    base_hex = mm2.group(1)
                    base_text = _utf16be_to_text(base_hex)
                    base_cp = ord(base_text[0]) if base_text else int(base_hex, 16)
                    for code in range(lo, min(hi, lo + 65535) + 1):
                        self.cmap[code] = chr(base_cp + (code - lo))
                    pos += mm2.end()

    def decode(self, raw: bytes) -> str:
        if self.cmap:
            out: List[str] = []
            step = self.code_len
            for i in range(0, len(raw) - step + 1, step):
                code = int.from_bytes(raw[i : i + step], "big")
                mapped = self.cmap.get(code)
                if mapped is None and step == 2:
                    # Some CMaps mix widths; retry single byte.
                    mapped = self.cmap.get(raw[i])
                if mapped is None and step == 1 and 0x20 <= code <= 0xFF:
                    # Unmapped printable SINGLE-byte code (typically the
                    # space): fall back to Latin-1 rather than dropping it.
                    # 2-byte CIDs are glyph indices — Latin-1 would be
                    # mojibake for subset fonts with partial ToUnicode.
                    mapped = chr(code)
                out.append(mapped if mapped is not None else "")
            return "".join(out)
        if self.code_len == 2:
            # Identity CID without ToUnicode: best-effort UTF-16BE.
            return raw.decode("utf-16-be", errors="ignore")
        return raw.decode("latin-1", errors="ignore")


_DEFAULT_FONT = FontDecoder.__new__(FontDecoder)
_DEFAULT_FONT.code_len = 1
_DEFAULT_FONT.cmap = {}


# ---------------------------------------------------------------------------
# Content-stream text interpreter
# ---------------------------------------------------------------------------

def extract_page_text(content: bytes, fonts: Dict[str, FontDecoder]) -> str:
    lex = _Lexer(content)
    stack: List[object] = []
    font = _DEFAULT_FONT
    lines: List[List[str]] = [[]]
    last_ty: Optional[float] = None

    def newline() -> None:
        if lines[-1]:
            lines.append([])

    def emit(raw) -> None:
        if isinstance(raw, bytes):
            text = font.decode(raw)
            if text:
                lines[-1].append(text)

    while True:
        save = lex.pos
        try:
            obj = parse_object(lex)
        except Exception:
            break
        if obj is None and lex.pos == save:
            break
        if isinstance(obj, Keyword):  # operator
            op = bytes(obj)
            if op == b"Tj":
                if stack:
                    emit(stack[-1])
            elif op == b"TJ":
                if stack and isinstance(stack[-1], list):
                    for el in stack[-1]:
                        if isinstance(el, bytes):
                            emit(el)
                        elif isinstance(el, (int, float)) and el < -180:
                            lines[-1].append(" ")
            elif op == b"'":
                newline()
                if stack:
                    emit(stack[-1])
            elif op == b'"':
                newline()
                if stack:
                    emit(stack[-1])
            elif op in (b"T*", b"TD"):
                newline()
            elif op == b"Td":
                if len(stack) >= 2 and isinstance(stack[-1], (int, float)):
                    ty = float(stack[-1])
                    if ty != 0:
                        newline()
                    elif stack[-2] and lines[-1]:
                        lines[-1].append(" ")
            elif op == b"Tm":
                if len(stack) >= 1 and isinstance(stack[-1], (int, float)):
                    ty = float(stack[-1])
                    if last_ty is None or abs(ty - last_ty) > 0.1:
                        newline()
                    last_ty = ty
            elif op == b"BT":
                newline()
            elif op == b"Tf":
                if len(stack) >= 2 and isinstance(stack[-2], Name):
                    font = fonts.get(str(stack[-2]), _DEFAULT_FONT)
            elif op == b"BI":
                # Inline image: BI <dict entries> ID <binary> EI. The
                # binary payload must NOT reach the object lexer — a
                # stray '(' byte inside it would be parsed as a literal
                # string that swallows the rest of the stream (and every
                # Tj after the image with it). Skip to past the next EI
                # delimited by whitespace.
                data = lex.data
                pos = lex.pos
                while True:
                    ei = data.find(b"EI", pos)
                    if ei < 0:
                        lex.pos = lex.n
                        break
                    before = data[ei - 1 : ei]
                    after = data[ei + 2 : ei + 3]
                    if (
                        (not before or before.isspace())
                        and (not after or after in b" \t\r\n\f/[<(%")
                    ):
                        lex.pos = ei + 2
                        break
                    pos = ei + 2
            stack.clear()
        else:
            stack.append(obj)
        if lex.pos >= lex.n:
            break

    text_lines = ["".join(parts).strip() for parts in lines]
    return "\n".join(ln for ln in text_lines if ln)


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

def load_pdf(path: Path, *, enable_ocr: bool = False) -> Pages:
    data = Path(path).read_bytes()
    doc = PdfDocument(data)
    pages: Pages = []
    for i, page in enumerate(doc.pages(), start=1):
        content = doc.page_content(page)
        fonts = doc.page_fonts(page)
        text = extract_page_text(content, fonts).strip()
        if not text and enable_ocr:
            text = _ocr_page(path, i)
        if text:
            pages.append((i, text))
    return pages


def _ocr_page(path: Path, page_number: int) -> str:
    """OCR fallback for scanned pages; gated on optional deps."""
    try:
        from pdf2image import convert_from_path  # type: ignore
        import pytesseract  # type: ignore
    except ImportError:
        log.warning(
            "OCR requested for %s page %d but pdf2image/pytesseract are "
            "not installed; skipping.", path, page_number,
        )
        return ""
    try:
        images = convert_from_path(
            str(path), first_page=page_number, last_page=page_number, dpi=200
        )
        return "\n".join(pytesseract.image_to_string(img) for img in images).strip()
    except Exception as exc:  # pragma: no cover - depends on system binaries
        log.warning("OCR failed for %s page %d: %s", path, page_number, exc)
        return ""
