"""Plan and pack: host milliseconds a 1,000 documents lowering rules
files (the function-variable files each chunk), loading the plan and
relocating each chunk into it, from the program's `lower_compile`,
`load_plan` and `relocate` spans."""


def read(run):
    names = ("lower_compile", "load_plan", "relocate")
    if not run.docs or not any(n in run.spans for n in names):
        return None
    return sum(run.spans.get(n, 0.0) for n in names) * 1e6 / run.docs
