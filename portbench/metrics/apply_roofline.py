"""Share of the element applies' bound (%): `counts/element_apply.py` at the
program-traced cycle's K and M calls and their mean columns, through
`peaks.bound_s`, over the device seconds put down to the
`diffsound.fem.{k,m}_apply` spans (harness/spans.py::readings)."""

from harness import spans


def read(ctx):
    return spans.readings(ctx.get("spans"), ctx["dims"])["apply_roofline"]
