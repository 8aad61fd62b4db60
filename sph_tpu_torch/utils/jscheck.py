"""Minimal JavaScript syntax sanity checker (no JS runtime needed).

Copied from sph_tpu/utils/jscheck.py, which uses no jax.  The interactive
explorer (`sph_tpu_torch/vis_interactive.py`, reference parity:
vis/Renderer.cpp:467-651) embeds a vanilla-JS script in a standalone HTML
file.  The build image has no node/browser, so this module
provides the strongest static validation available in pure Python: a
JS-aware tokenizer (comments, strings, template literals with ${}
nesting, regex literals) plus bracket-balance and termination checks.
It rejects the dominant classes of accidental syntax error — unbalanced
braces/parens/brackets, unterminated strings or comments, stray closers —
which is exactly how a hand-edited embedded script breaks in practice.
"""

from __future__ import annotations

# tokens after which a `/` begins a regex literal rather than division
_REGEX_PRECEDERS = {
    "(", ",", "=", ":", "[", "!", "&", "|", "?", "{", "}", ";", "+", "-",
    "*", "%", "<", ">", "^", "~", "return", "typeof", "instanceof", "in",
    "of", "new", "do", "else", "case", "delete", "throw", "void", "=>",
    None,
}

_OPEN = {"(": ")", "[": "]", "{": "}"}
_CLOSE = {")": "(", "]": "[", "}": "{"}


class JsSyntaxError(ValueError):
    pass


def _err(msg: str, line: int) -> None:
    raise JsSyntaxError(f"line {line}: {msg}")


def check_js_syntax(src: str) -> int:
    """Validate `src` for structural JS syntax errors.

    Returns the number of significant (non-comment, non-whitespace)
    tokens seen.  Raises JsSyntaxError on: unbalanced or mismatched
    ()/[]/{}, unterminated string / template / regex / block comment.
    """
    i, n = 0, len(src)
    line = 1
    stack: list[tuple[str, int]] = []  # (opener, line)
    prev_tok: str | None = None
    ntokens = 0

    def scan_string(quote: str, start_line: int) -> None:
        nonlocal i, line
        i += 1
        while i < n:
            c = src[i]
            if c == "\\":
                i += 2
                continue
            if c == quote:
                i += 1
                return
            if c == "\n":
                _err(f"unterminated string (opened with {quote})",
                     start_line)
            i += 1
        _err(f"unterminated string (opened with {quote})", start_line)

    def scan_template(start_line: int) -> None:
        # template literal; `${ ... }` bodies recurse into the main scanner
        # via the bracket stack with a sentinel
        nonlocal i, line
        i += 1
        while i < n:
            c = src[i]
            if c == "\\":
                i += 2
                continue
            if c == "`":
                i += 1
                return
            if c == "\n":
                line += 1
                i += 1
                continue
            if c == "$" and i + 1 < n and src[i + 1] == "{":
                # scan the interpolation body with balanced braces
                i += 2
                depth = 1
                while i < n and depth:
                    ch = src[i]
                    if ch == "{":
                        depth += 1
                    elif ch == "}":
                        depth -= 1
                    elif ch == "\n":
                        line += 1
                    elif ch in "\"'":
                        scan_string(ch, line)
                        continue
                    elif ch == "`":
                        scan_template(line)
                        continue
                    i += 1
                if depth:
                    _err("unterminated ${...} interpolation", start_line)
                continue
            i += 1
        _err("unterminated template literal", start_line)

    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if c == "/" and i + 1 < n and src[i + 1] == "/":
            while i < n and src[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and src[i + 1] == "*":
            start = line
            i += 2
            while i < n and not (src[i] == "*" and i + 1 < n
                                 and src[i + 1] == "/"):
                if src[i] == "\n":
                    line += 1
                i += 1
            if i >= n:
                _err("unterminated block comment", start)
            i += 2
            continue
        if c in "\"'":
            scan_string(c, line)
            prev_tok = "<string>"
            ntokens += 1
            continue
        if c == "`":
            scan_template(line)
            prev_tok = "<template>"
            ntokens += 1
            continue
        if c == "/" and prev_tok in _REGEX_PRECEDERS:
            start = line
            i += 1
            in_class = False
            while i < n:
                ch = src[i]
                if ch == "\\":
                    i += 2
                    continue
                if ch == "\n":
                    _err("unterminated regex literal", start)
                if ch == "[":
                    in_class = True
                elif ch == "]":
                    in_class = False
                elif ch == "/" and not in_class:
                    i += 1
                    break
                i += 1
            else:
                _err("unterminated regex literal", start)
            while i < n and src[i].isalpha():  # flags
                i += 1
            prev_tok = "<regex>"
            ntokens += 1
            continue
        if c in _OPEN:
            stack.append((c, line))
            prev_tok = c
            ntokens += 1
            i += 1
            continue
        if c in _CLOSE:
            if not stack:
                _err(f"unmatched '{c}'", line)
            opener, oline = stack.pop()
            if _OPEN[opener] != c:
                _err(f"mismatched '{c}' (expected '{_OPEN[opener]}' "
                     f"for '{opener}' opened at line {oline})", line)
            prev_tok = c
            ntokens += 1
            i += 1
            continue
        if c.isalpha() or c in "_$":
            j = i
            while j < n and (src[j].isalnum() or src[j] in "_$"):
                j += 1
            prev_tok = src[i:j]
            ntokens += 1
            i = j
            continue
        if c.isdigit():
            j = i
            while j < n and (src[j].isalnum() or src[j] == "."):
                j += 1
            prev_tok = "<number>"
            ntokens += 1
            i = j
            continue
        # operator / punctuation: greedily take => as one token for the
        # regex-preceder heuristic; otherwise single char
        if c == "=" and i + 1 < n and src[i + 1] == ">":
            prev_tok = "=>"
            i += 2
        else:
            prev_tok = c
            i += 1
        ntokens += 1

    if stack:
        opener, oline = stack[0]
        _err(f"unclosed '{opener}'", oline)
    return ntokens


def extract_scripts(html: str) -> list[str]:
    """Return the bodies of all <script>...</script> blocks."""
    import re
    return re.findall(r"<script[^>]*>(.*?)</script>", html, re.S | re.I)
