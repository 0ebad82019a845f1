"""The plain reference of a sweep's answers.

`guard/` is a frozen copy of the port's tree-walking evaluator (its
`core/` modules), which shares no code with the port's encode, IR or
kernel path and imports nothing of the port, of the JAX package or of
JAX. `sweep.py` works from the rule texts and the document texts alone.
"""
