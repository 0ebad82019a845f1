"""Minimal embedding example for the port's library API: the
counterpart of the JAX package's examples/library.py (the reference's
library example, `guard-examples/library/src/main.rs:22-45`): build a
Validate command programmatically, feed a payload through an injected
reader, and capture structured output — no files, no CLI.

Run: python -m guard_tpu_torch.examples.library [--device cpu]

ValidateBuilder's run is on the CUDA card unless `--device` names
another device (`cpu`: the plain versions of the kernels).
"""

import argparse
import json

import guard_tpu_torch
from guard_tpu_torch.api import ValidateBuilder
from guard_tpu_torch.utils.io import Reader, Writer

RULES = """
rule s3_bucket_server_side_encryption {
    Resources.*[ Type == 'AWS::S3::Bucket' ] {
        Properties.BucketEncryption exists
    }
}
"""

TEMPLATE = json.dumps(
    {
        "Resources": {
            "logs": {
                "Type": "AWS::S3::Bucket",
                "Properties": {"BucketEncryption": {"ServerSideEncryptionConfiguration": []}},
            },
            "scratch": {"Type": "AWS::S3::Bucket", "Properties": {}},
        }
    }
)


def one_shot() -> None:
    """run_checks: single (data, rules) pair -> JSON report string."""
    report = guard_tpu_torch.run_checks(TEMPLATE, RULES)
    print("run_checks ->")
    print(json.dumps(json.loads(report), indent=2)[:400], "...")


def builder_payload(device=None) -> None:
    """ValidateBuilder payload mode (the wasm/npm entry in the
    reference, lib.rs:318-347): rules+data from one JSON payload."""
    payload = json.dumps({"rules": [RULES], "data": [TEMPLATE]})
    cmd = (
        ValidateBuilder()
        .payload(True)
        .structured(True)
        .output_format("json")
        .show_summary(["none"])
        .device(device)
        .try_build()
    )
    writer = Writer.buffered()
    code = cmd.execute(writer, Reader.from_string(payload))
    print(f"builder payload exit code: {code}")
    print(writer.stripped()[:400], "...")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    device = ap.parse_args().device
    one_shot()
    builder_payload(device)
