"""The `rulegen` command: autogenerate rules from a CFN template.

A copy of the JAX package's guard_tpu/commands/rulegen.py (host only):
the equivalent of cfn-guard's `guard/src/commands/rulegen.rs:44-245`:
group resource property values by resource Type, emit
`let <type>_resources = Resources.*[ Type == '<Type>' ]` + a rule with
`==` / `IN` clauses, then re-parse the generated output as a self-check.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Set

import yaml

from ..core.errors import ParseError
from ..core.parser import parse_rules_file
from ..utils.io import Reader, Writer

SUCCESS = 0
ERROR = 5


def gen_rules(cfn_resources: dict) -> Dict[str, Dict[str, Set[str]]]:
    """rulegen.rs:94-176: Type -> property -> set of rendered values."""
    rule_map: Dict[str, Dict[str, Set[str]]] = {}
    for _name, resource in cfn_resources.items():
        if not isinstance(resource, dict):
            continue
        props = resource.get("Properties")
        rtype = resource.get("Type")
        if not isinstance(props, dict) or not isinstance(rtype, str):
            continue
        for prop_name, prop_val in props.items():
            if isinstance(prop_val, str):
                rendered = '"' + prop_val.strip().replace("\n", "") + '"'
            else:
                # compact separators match the reference's serde_json
                # to_string output (rulegen.rs golden files)
                rendered = json.dumps(prop_val, separators=(",", ":"))
                rendered = rendered.strip().replace("\n", "")
            rule_map.setdefault(rtype, {}).setdefault(prop_name, set()).add(rendered)
    return rule_map


def print_rules(rule_map: Dict[str, Dict[str, Set[str]]], writer: Writer) -> None:
    """rulegen.rs:187-245."""
    out = []
    for resource in sorted(rule_map):
        properties = rule_map[resource]
        resource_name_underscore = resource.replace("::", "_").lower()
        variable_name = f"{resource_name_underscore}_resources"
        out.append(f"let {variable_name} = Resources.*[ Type == '{resource}' ]\n")
        out.append(f"rule {resource_name_underscore} when %{variable_name} !empty {{\n")
        for prop in sorted(properties):
            values = sorted(properties[prop])
            if len(values) > 1:
                out.append(
                    f"  %{variable_name}.Properties.{prop} IN [{', '.join(values)}]\n"
                )
            else:
                out.append(f"  %{variable_name}.Properties.{prop} == {values[0]}\n")
        out.append("}\n")
    generated = "".join(out)
    # self-check: the generated rules must re-parse (rulegen.rs:230-243)
    try:
        parse_rules_file(generated, "")
    except ParseError as e:
        writer.write_err(f"Parsing error with generated rules file, Error = {e}")
        return
    writer.write(generated)


@dataclass
class Rulegen:
    template: str = ""
    output: Optional[str] = None

    def execute(self, writer: Writer, reader: Reader) -> int:
        try:
            content = Path(self.template).read_text()
        except OSError as e:
            writer.writeln_err(str(e))
            return ERROR
        try:
            template = yaml.safe_load(content)
        except yaml.YAMLError as e:
            writer.write_err(f"Parsing error handling template file, Error = {e}")
            return 1
        if not isinstance(template, dict) or "Resources" not in template:
            writer.write_err("Template lacks a Resources section")
            return 1
        rule_map = gen_rules(template["Resources"])
        print_rules(rule_map, writer)
        return SUCCESS
