"""Raw probe-record parsing: the formatter mini-DSL.

Behavioral port of the reference's Formatter (Formatter.java:36-51): the
config string's first character is the separator used to split the *config
itself*; the first argument selects the record type:

  sv:   separator-regex, uuid col, lat col, lon col, time col, accuracy col,
        [date format]            e.g.  ,sv,\\|,1,9,10,0,5,yyyy-MM-dd HH:mm:ss
  json: uuid key, lat key, lon key, time key, accuracy key, [date format]
        e.g.  @json@id@latitude@longitude@timestamp@accuracy

The sv separator is a *regex* (Java String.split semantics).  Dates are
joda-style patterns interpreted in UTC; without a date format the time field
is already epoch seconds.  Accuracy is ceiled to whole meters
(Formatter.java:104,122: 6.5 -> 7).
"""

from __future__ import annotations

import json
import math
import re
from datetime import datetime, timezone
from typing import Optional, Tuple

from .point import Point

# joda-time pattern tokens -> strptime (the subset real deployments use)
_JODA = {
    "yyyy": "%Y",
    "yy": "%y",
    "MM": "%m",
    "dd": "%d",
    "HH": "%H",
    "mm": "%M",
    "ss": "%S",
    "SSS": "%f",
}


def joda_to_strptime(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c.isalpha():
            j = i
            while j < len(pattern) and pattern[j] == c:
                j += 1
            run = pattern[i:j]
            if run not in _JODA:
                raise ValueError("unsupported date pattern token %r in %r" % (run, pattern))
            out.append(_JODA[run])
            i = j
        else:
            if c == "%":
                out.append("%%")
            else:
                out.append(c)
            i += 1
    return "".join(out)


class Formatter:
    """Parses one raw record into (uuid, Point)."""

    def __init__(
        self,
        kind: str,
        fields: Tuple[str, ...],
        date_format: Optional[str] = None,
    ):
        if kind not in ("sv", "json"):
            raise ValueError("unsupported raw format parser %r" % (kind,))
        self.kind = kind
        self.fields = fields
        self.strptime = joda_to_strptime(date_format) if date_format else None
        if kind == "sv":
            sep, uuid_i, lat_i, lon_i, time_i, acc_i = fields
            self.sep = re.compile(sep)
            self.uuid_i = int(uuid_i)
            self.lat_i = int(lat_i)
            self.lon_i = int(lon_i)
            self.time_i = int(time_i)
            self.acc_i = int(acc_i)
        else:
            self.uuid_k, self.lat_k, self.lon_k, self.time_k, self.acc_k = fields

    @classmethod
    def from_config(cls, config: str) -> "Formatter":
        """First char = separator for the config string itself
        (Formatter.java:36-51)."""
        if len(config) < 2:
            raise ValueError("formatter config too short: %r" % (config,))
        split_on = config[0]
        args = config[1:].split(split_on)
        if args[0] == "sv":
            if len(args) < 7:
                raise ValueError("sv formatter needs 6+ args, got %r" % (args,))
            return cls("sv", tuple(args[1:7]), args[7] if len(args) > 7 else None)
        if args[0] == "json":
            if len(args) < 6:
                raise ValueError("json formatter needs 5+ args, got %r" % (args,))
            return cls("json", tuple(args[1:6]), args[6] if len(args) > 6 else None)
        raise ValueError("unsupported raw format parser %r" % (args[0],))

    def _time(self, raw) -> int:
        if self.strptime is not None:
            dt = datetime.strptime(str(raw), self.strptime).replace(tzinfo=timezone.utc)
            return int(dt.timestamp())
        return int(raw)

    def format(self, message: str) -> Tuple[str, Point]:
        if self.kind == "sv":
            parts = self.sep.split(message)
            return parts[self.uuid_i], Point(
                lat=float(parts[self.lat_i]),
                lon=float(parts[self.lon_i]),
                accuracy=int(math.ceil(float(parts[self.acc_i]))),
                time=self._time(parts[self.time_i]),
            )
        node = json.loads(message)
        return str(node[self.uuid_k]), Point(
            lat=float(node[self.lat_k]),
            lon=float(node[self.lon_k]),
            accuracy=int(math.ceil(float(node[self.acc_k]))),
            time=self._time(node[self.time_k]),
        )
