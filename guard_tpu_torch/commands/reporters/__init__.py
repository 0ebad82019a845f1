"""Reporters of a validate run, one module each as in the JAX package's
guard_tpu/commands/reporters/:

- `console`: the SummaryTable header and the generic single-line body;
- `aware`: the template-aware console chain (CloudFormation, Terraform
  plan, generic) and, for `-o json|yaml` without `--structured`, each
  pair's serialized FileReport;
- `structured`: `--structured -o json|yaml`, one combined FileReport a
  document;
- `sarif`: `--structured -o sarif`;
- `junit`: `--structured -o junit`.
"""

from .aware import console_chain

__all__ = ["console_chain"]
