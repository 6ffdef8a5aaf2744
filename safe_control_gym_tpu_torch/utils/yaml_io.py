"""A reader and a writer for the subset of YAML that the repository's configs use.

The machines the port runs on need not have PyYAML, and the examples' configs
are YAML. ``load`` reads what those files use and gives what
``yaml.safe_load`` gives on them:

* block mappings and block sequences (a sequence may sit at its key's
  indent), sequences of mappings (``- key: value``);
* flow sequences ``[...]`` and flow mappings ``{...}`` on one line, nested;
* plain, single-quoted and double-quoted scalars, and comments.

Scalars resolve as PyYAML's YAML 1.1 resolver resolves them: ``True``,
``yes`` and ``on`` are booleans, ``~`` and ``null`` are None, ``1e-3``
(no dot) is a string while ``1.0e-3`` is a float, ``0o17`` is a string
and ``017`` an octal int. Anything else (anchors, aliases, tags, block
scalars ``|`` and ``>``, complex keys, multi-line plain or flow scalars,
documents, timestamps, merge keys) raises ``YAMLSubsetError`` with the file
and line, so that nothing is misread silently.

``dump`` writes block style (PyYAML's ``default_flow_style=False``) that
``load`` and ``yaml.safe_load`` read back to the same value.

    cfg = load_file('examples/rl/config_overrides/cartpole/ppo_cartpole.yaml')
    with open('config.yaml', 'w') as f:
        dump(cfg, f)
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

__all__ = ['YAMLSubsetError', 'load', 'load_file', 'dump', 'dumps']


class YAMLSubsetError(ValueError):
    """A construct outside the subset, or malformed input, at a named line."""


# PyYAML's implicit resolvers (yaml/resolver.py), tried in its order for the
# scalar's first character.
_BOOL = re.compile(r'^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE'
                   r'|on|On|ON|off|Off|OFF)$')
_FLOAT = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X)
_INT = re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_NULL = re.compile(r'^(?:~|null|Null|NULL|)$')
_TIMESTAMP = re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''', re.X)

_BOOL_VALUES = {'yes': True, 'no': False, 'true': True, 'false': False,
                'on': True, 'off': False}
_ESCAPES = {'0': '\0', 'a': '\x07', 'b': '\x08', 't': '\t', '\t': '\t', 'n': '\n',
            'v': '\x0b', 'f': '\x0c', 'r': '\r', 'e': '\x1b', ' ': ' ', '"': '"',
            '/': '/', '\\': '\\', 'N': '\x85', '_': '\xa0', 'L': ' ',
            'P': ' '}
_HEX_ESCAPES = {'x': 2, 'u': 4, 'U': 8}
# Characters that open a construct outside the subset when they start a
# plain scalar.
_REFUSED_START = {'&': 'an anchor', '*': 'an alias', '!': 'a tag',
                  '|': 'a block scalar', '>': 'a block scalar', '%': 'a directive',
                  '@': 'a reserved indicator', '`': 'a reserved indicator',
                  '?': 'a complex key'}


def _sexagesimal(text, cast):
    value = 0
    for part in text.split(':'):
        value = value * 60 + cast(part)
    return value


def _resolve_plain(text: str, where: str):
    """A plain scalar's value, as ``yaml.safe_load`` resolves it."""
    first = text[:1]
    if first in 'yYnNtTfFoO' and _BOOL.match(text):
        return _BOOL_VALUES[text.lower()]
    if first in '-+0123456789.' and _FLOAT.match(text):
        v = text.replace('_', '').lower()
        sign = -1 if v[0] == '-' else 1
        v = v.lstrip('+-')
        if v == '.inf':
            return sign * 1e300 * 1e300
        if v == '.nan':
            return math.nan
        return sign * (_sexagesimal(v, float) if ':' in v else float(v))
    if first in '-+0123456789' and _INT.match(text):
        v = text.replace('_', '')
        sign = -1 if v[0] == '-' else 1
        v = v.lstrip('+-')
        if v == '0':
            return 0
        if v.startswith('0b'):
            return sign * int(v[2:], 2)
        if v.startswith('0x'):
            return sign * int(v[2:], 16)
        if v[0] == '0':
            return sign * int(v, 8)
        return sign * (_sexagesimal(v, int) if ':' in v else int(v))
    if first == '<' and text == '<<':
        raise YAMLSubsetError(f'{where}: merge keys (<<) are not supported')
    if first in '~nN' or text == '':
        if _NULL.match(text):
            return None
    if first in '0123456789' and _TIMESTAMP.match(text):
        raise YAMLSubsetError(f'{where}: timestamps are not supported ({text!r})')
    if text == '=':
        raise YAMLSubsetError(f'{where}: the value key (=) is not supported')
    return text


def _scan_double(s: str, i: int, where: str) -> Tuple[str, int]:
    """The double-quoted scalar opening at ``s[i]``; returns (value, end)."""
    out, j = [], i + 1
    while j < len(s):
        c = s[j]
        if c == '"':
            return ''.join(out), j + 1
        if c == '\\':
            j += 1
            if j >= len(s):
                break
            e = s[j]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 1
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                code = s[j + 1:j + 1 + n]
                if len(code) != n or not re.fullmatch(r'[0-9a-fA-F]+', code):
                    raise YAMLSubsetError(f'{where}: bad escape \\{e}{code}')
                out.append(chr(int(code, 16)))
                j += 1 + n
            else:
                raise YAMLSubsetError(f'{where}: unknown escape \\{e}')
            continue
        out.append(c)
        j += 1
    raise YAMLSubsetError(f'{where}: a double-quoted scalar must end on its line')


def _scan_single(s: str, i: int, where: str) -> Tuple[str, int]:
    out, j = [], i + 1
    while j < len(s):
        if s[j] == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return ''.join(out), j + 1
        out.append(s[j])
        j += 1
    raise YAMLSubsetError(f'{where}: a single-quoted scalar must end on its line')


def _scan_quoted(s, i, where):
    return (_scan_double if s[i] == '"' else _scan_single)(s, i, where)


def _strip_comment(s: str) -> str:
    """``s`` without a trailing comment (a ``#`` at the start or after
    whitespace, outside quotes)."""
    i, quote = 0, None
    while i < len(s):
        c = s[i]
        if quote == "'":
            if c == "'":
                if s[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif quote == '"':
            if c == '\\':
                i += 2
                continue
            if c == '"':
                quote = None
        elif c == '#' and (i == 0 or s[i - 1] in ' \t'):
            return s[:i].rstrip()
        elif c in '\'"' and (i == 0 or s[i - 1] in ' \t[{,:-'):
            quote = c
        i += 1
    return s.rstrip()


def _find_colon(s: str) -> int:
    """Index of the mapping colon of a line (``:`` followed by a space or
    the end, outside quotes and brackets), or -1."""
    i, depth = 0, 0
    if s[:1] in '\'"':
        try:
            _, i = _scan_quoted(s, 0, '')
        except YAMLSubsetError:
            return -1
    while i < len(s):
        c = s[i]
        if c in '[{':
            depth += 1
        elif c in ']}':
            depth -= 1
        elif c == ':' and depth <= 0 and (i + 1 == len(s) or s[i + 1] in ' \t'):
            return i
        i += 1
    return -1


class _Flow:
    """A one-line flow collection or scalar parsed from ``text``."""

    def __init__(self, text: str, where: str):
        self.s, self.i, self.where = text, 0, where

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in ' \t':
            self.i += 1

    def _peek(self):
        self._ws()
        return self.s[self.i] if self.i < len(self.s) else ''

    def node(self, in_flow: bool):
        c = self._peek()
        if c == '[':
            return self._seq()
        if c == '{':
            return self._map()
        if c in '\'"':
            value, self.i = _scan_quoted(self.s, self.i, self.where)
            return value
        return self._plain(in_flow)

    def _plain(self, in_flow: bool):
        start = self.i
        c = self.s[start:start + 1]
        if c in _REFUSED_START:
            raise YAMLSubsetError(f'{self.where}: {_REFUSED_START[c]} is not supported')
        if c in ('-', ':') and self.s[start + 1:start + 2] in ('', ' ', '\t', ',', ']', '}'):
            raise YAMLSubsetError(f'{self.where}: unexpected {c!r}')
        stop = ',[]{}' if in_flow else ''
        j = start
        while j < len(self.s):
            ch = self.s[j]
            if ch in stop:
                break
            if ch == ':' and (j + 1 == len(self.s) or self.s[j + 1] in ' \t' + stop):
                break
            j += 1
        self.i = j
        return _resolve_plain(self.s[start:j].rstrip(), self.where)

    def _seq(self):
        self.i += 1
        out = []
        while True:
            c = self._peek()
            if c == ']':
                self.i += 1
                return out
            if c == '':
                raise YAMLSubsetError(f'{self.where}: a flow sequence must end on its line')
            item = self.node(in_flow=True)
            if self._peek() == ':':
                raise YAMLSubsetError(f'{self.where}: a mapping inside a flow sequence '
                                      'is not supported')
            out.append(item)
            self._sep(']')

    def _map(self):
        self.i += 1
        out = {}
        while True:
            c = self._peek()
            if c == '}':
                self.i += 1
                return out
            if c == '':
                raise YAMLSubsetError(f'{self.where}: a flow mapping must end on its line')
            if c in '[{':
                raise YAMLSubsetError(f'{self.where}: complex keys are not supported')
            key = self.node(in_flow=True)
            if self._peek() == ':':
                self.i += 1
                value = None if self._peek() in (',', '}') else self.node(in_flow=True)
            else:
                value = None
            out[key] = value
            self._sep('}')

    def _sep(self, close):
        c = self._peek()
        if c == ',':
            self.i += 1
        elif c != close:
            raise YAMLSubsetError(f'{self.where}: expected "," or "{close}"')

    def end(self):
        if self._peek() != '':
            raise YAMLSubsetError(f'{self.where}: unexpected text '
                                  f'{self.s[self.i:]!r} after the value')


class _Block:
    """The block structure: lines of (number, indent, text), comments and
    blank lines dropped."""

    def __init__(self, text: str, name: str):
        self.name = name
        self.lines: List[List[Any]] = []
        for n, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(' ')
            if body.startswith('\t') or (body and '\t' in raw[:len(raw) - len(body)]):
                raise YAMLSubsetError(f'{name}:{n}: tabs in indentation are not supported')
            body = _strip_comment(body)
            if not body:
                continue
            if n == 1 and body.startswith('%') or body in ('---', '...') \
                    or body.startswith('--- '):
                raise YAMLSubsetError(f'{name}:{n}: document markers and directives '
                                      'are not supported')
            self.lines.append([n, len(raw) - len(raw.lstrip(' ')), body])

    def where(self, i):
        return f'{self.name}:{self.lines[i][0]}'

    def parse(self):
        if not self.lines:
            return None
        value, i = self.node(0, self.lines[0][1])
        if i < len(self.lines):
            raise YAMLSubsetError(f'{self.where(i)}: unexpected indentation')
        return value

    @staticmethod
    def _is_item(body):
        return body == '-' or body.startswith('- ')

    def node(self, i, indent):
        _, ind, body = self.lines[i]
        if ind != indent:
            raise YAMLSubsetError(f'{self.where(i)}: unexpected indentation')
        if self._is_item(body):
            return self.sequence(i, indent)
        if body[0] not in '[{' and _find_colon(body) >= 0:
            return self.mapping(i, indent)
        return self.inline(i, body, indent)

    def inline(self, i, text, indent):
        """A value written on line ``i`` (a scalar or a flow collection)."""
        where = self.where(i)
        flow = _Flow(text, where)
        value = flow.node(in_flow=False)
        flow.end()
        if i + 1 < len(self.lines) and self.lines[i + 1][1] > indent:
            raise YAMLSubsetError(f'{self.where(i + 1)}: multi-line scalars are not '
                                  'supported')
        return value, i + 1

    def _child(self, i, indent, allow_seq_at_indent):
        """The value of an entry whose text ended at line ``i``: a nested block
        on the following lines, or None."""
        if i + 1 < len(self.lines):
            _, ind, body = self.lines[i + 1]
            if ind > indent or (allow_seq_at_indent and ind == indent and self._is_item(body)):
                return self.node(i + 1, ind)
        return None, i + 1

    def mapping(self, i, indent):
        out = {}
        while i < len(self.lines) and self.lines[i][1] == indent:
            body = self.lines[i][2]
            where = self.where(i)
            if self._is_item(body):
                break
            if body.startswith('? ') or body == '?':
                raise YAMLSubsetError(f'{where}: complex keys are not supported')
            colon = _find_colon(body)
            if colon < 0:
                raise YAMLSubsetError(f'{where}: expected "key: value"')
            key_text = body[:colon].rstrip()
            if key_text[:1] in '[{':
                raise YAMLSubsetError(f'{where}: complex keys are not supported')
            kf = _Flow(key_text, where)
            key = kf.node(in_flow=False)
            kf.end()
            rest = body[colon + 1:].strip()
            if rest:
                value, i = self.inline(i, rest, indent)
            else:
                value, i = self._child(i, indent, allow_seq_at_indent=True)
            out[key] = value
        if i < len(self.lines) and self.lines[i][1] > indent:
            raise YAMLSubsetError(f'{self.where(i)}: unexpected indentation')
        return out, i

    def sequence(self, i, indent):
        out = []
        while i < len(self.lines) and self.lines[i][1] == indent \
                and self._is_item(self.lines[i][2]):
            body = self.lines[i][2]
            rest = body[1:].lstrip(' ')
            if not rest:
                value, i = self._child(i, indent, allow_seq_at_indent=False)
            else:
                # The item's text is a node of its own at its column.
                self.lines[i] = [self.lines[i][0], indent + len(body) - len(rest), rest]
                value, i = self.node(i, self.lines[i][1])
            out.append(value)
        if i < len(self.lines) and self.lines[i][1] > indent:
            raise YAMLSubsetError(f'{self.where(i)}: unexpected indentation')
        return out, i


def load(text: str, name: str = '<string>'):
    """The value of one YAML document in the subset (see the module
    docstring); ``name`` goes into error messages."""
    return _Block(text, name).parse()


def load_file(path: str):
    with open(path) as f:
        return load(f.read(), path)


# -- writer ------------------------------------------------------------

_PLAIN_SAFE = re.compile(r'^[A-Za-z0-9_./()+-][^\n]*$')


def _scalar(value) -> str:
    if value is None:
        return 'null'
    if isinstance(value, bool):
        return 'true' if value else 'false'
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return '.nan'
        if math.isinf(value):
            return '.inf' if value > 0 else '-.inf'
        text = repr(value)
        if '.' not in text and 'e' in text:
            # 1e-05 would read back as a string.
            mant, exp = text.split('e')
            text = f'{mant}.0e{exp}'
        return text
    if isinstance(value, str):
        if (_PLAIN_SAFE.match(value) and value == value.strip()
                and not any(t in value for t in (': ', ' #', '\t'))
                and not value.endswith(':') and not value.startswith('- ')
                and _resolve_plain_safe(value) == value):
            return value
        if all(c.isprintable() for c in value):
            return "'" + value.replace("'", "''") + "'"
        return '"' + ''.join(c if c.isprintable() and c not in '"\\' else
                             {'"': '\\"', '\\': '\\\\', '\n': '\\n', '\t': '\\t'}.get(
                                 c, f'\\u{ord(c):04x}') for c in value) + '"'
    raise TypeError(f'yaml_io.dump: cannot write {type(value).__name__} {value!r}')


def _resolve_plain_safe(text):
    try:
        return _resolve_plain(text, '')
    except YAMLSubsetError:
        return None


def _plain_value(value):
    """Numpy scalars and tuples as the Python values they stand for."""
    if hasattr(value, 'item') and hasattr(value, 'dtype') and getattr(value, 'shape', None) == ():
        return value.item()
    if isinstance(value, tuple):
        return list(value)
    return value


def _emit(value, indent: int, out: List[str]):
    pad = ' ' * indent
    if isinstance(value, dict):
        for k, v in value.items():
            v = _plain_value(v)
            key = _scalar(_plain_value(k))
            if isinstance(v, dict) and v:
                out.append(f'{pad}{key}:')
                _emit(v, indent + 2, out)
            elif isinstance(v, list) and v:
                out.append(f'{pad}{key}:')
                _emit(v, indent, out)
            else:
                out.append(f'{pad}{key}: {_inline(v)}')
        return
    for v in value:
        v = _plain_value(v)
        if isinstance(v, (dict, list)) and v:
            sub: List[str] = []
            _emit(v, indent + 2, sub)
            out.append(f'{pad}- {sub[0].lstrip(" ")}')
            out.extend(sub[1:])
        else:
            out.append(f'{pad}- {_inline(v)}')


def _inline(v) -> str:
    if isinstance(v, dict):
        return '{}'
    if isinstance(v, list):
        return '[]'
    return _scalar(v)


def dumps(value: Any) -> str:
    """``value`` (dicts, lists, tuples, str, int, float, bool, None and numpy
    scalars) as block-style YAML text."""
    value = _plain_value(value)
    if isinstance(value, (dict, list)) and value:
        out: List[str] = []
        _emit(value, 0, out)
        return '\n'.join(out) + '\n'
    return _inline(value) + '\n'


def dump(value: Any, stream) -> None:
    stream.write(dumps(value))
