"""Declarative option registry with HM-style config files.

Capability ref: TAppCommon/program_options_lite (program_options_lite.h:
`("Name,-short", storage, default, "desc")` registry; cfg files use
`Key : value  # comment` lines, CLI overrides cfg). This is a fresh
implementation of the same surface for the codec's apps
(utils/cli.py), so HM users can bring their option names along.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class _Opt:
    names: list          # long + short spellings
    key: str             # destination attribute
    default: object
    help: str
    typ: type


class Options:
    """`("Name,-n", key, default, help)` registry + cfg/CLI parser."""

    def __init__(self) -> None:
        self._opts: list[_Opt] = []
        self._by_name: dict[str, _Opt] = {}
        self.values: dict[str, object] = {}

    def add(self, spec: str, key: str, default, help: str = "") -> None:
        names = [s.strip() for s in spec.split(",")]
        typ = bool if isinstance(default, bool) else type(default)
        opt = _Opt(names, key, default, help, typ)
        self._opts.append(opt)
        for nm in names:
            self._by_name[nm.lstrip("-")] = opt
        self.values[key] = default

    def _coerce(self, opt: _Opt, raw: str):
        if opt.typ is bool:
            return raw.strip().lower() in ("1", "true", "yes", "on")
        if opt.typ is int:
            return int(raw, 0)
        if opt.typ is float:
            return float(raw)
        return raw.strip()

    def parse_cfg(self, path: str) -> None:
        """HM cfg file: `Key : value  # comment` (one per line)."""
        with open(path) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if not line or ":" not in line:
                    continue
                name, _, raw = line.partition(":")
                opt = self._by_name.get(name.strip())
                if opt is None:
                    continue     # unknown keys ignored, like HM's warnings
                self.values[opt.key] = self._coerce(opt, raw)

    def parse(self, argv: list) -> list:
        """CLI parse (after any -c cfg files, CLI wins). Returns leftover
        positional args. Accepted spellings: --Name=v, --Name v, -n v,
        and bare --FlagName for bools."""
        rest = []
        i = 0
        while i < len(argv):
            a = argv[i]
            if a == "-c":                    # config file
                self.parse_cfg(argv[i + 1])
                i += 2
                continue
            if a.startswith("-"):
                name, eq, val = a.lstrip("-").partition("=")
                opt = self._by_name.get(name)
                if opt is None:
                    raise SystemExit(f"unknown option {a}")
                if eq:
                    self.values[opt.key] = self._coerce(opt, val)
                    i += 1
                elif opt.typ is bool and (i + 1 >= len(argv)
                                          or argv[i + 1].startswith("-")):
                    self.values[opt.key] = True
                    i += 1
                else:
                    self.values[opt.key] = self._coerce(opt, argv[i + 1])
                    i += 2
            else:
                rest.append(a)
                i += 1
        return rest

    def help_text(self) -> str:
        out = []
        for o in self._opts:
            out.append(f"  {', '.join(o.names):34s} "
                       f"[{o.default!r}] {o.help}")
        return "\n".join(out)
