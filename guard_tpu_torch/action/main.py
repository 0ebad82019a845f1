"""GitHub Action entry point of the port: the counterpart of the JAX
package's action/main.py, with the same dispatch surface (the
reference action's `src/main.ts:17-60`):

  * validate -> SARIF (handleValidate.ts);
  * `analyze: true` -> fail the job and upload the gzip+base64 SARIF to
    the code-scanning API (uploadCodeScan.ts);
  * pull_request events -> intersect violations with the PR's changed
    files; with `create-review: true` post one review comment per
    violation, deleting stale duplicates first
    (handlePullRequestRun.ts:1-231);
  * push events -> rows for every violation (handlePushRun.ts);
  * violations render into the job summary and fail the job
    (handleWriteActionSummary.ts).

All GitHub API traffic goes through `GithubApi.request`, which tests
replace with a recording fake (the jest-mock pattern of
`action/__tests__/main.test.ts`).

validate runs through the port's CLI, on the CUDA card unless the
`device` input (INPUT_DEVICE, or `--device`) names another device:
`cpu` runs the plain versions of the kernels on a runner with no card.
"""

from __future__ import annotations

import argparse
import base64
import gzip
import json
import os
import sys
import urllib.request

# the checkout's root, two levels up (guard_tpu_torch/action/main.py)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from guard_tpu_torch.cli import run as cli_run  # noqa: E402
from guard_tpu_torch.utils.io import Reader, Writer  # noqa: E402

SARIF_PATH = "guard-tpu.sarif"
VALIDATION_FAILURE = "Validation failure. CFN Guard found violations."
SECURITY_TAB = "Review the Security tab for more details."

_DEBUG = [False]


def debug_log(msg: str) -> None:
    """debugLog.ts: gated on the `debug` input."""
    if _DEBUG[0]:
        print(f"::debug::{msg}")


def _bool(v: str) -> bool:
    return str(v).strip().lower() in ("1", "true", "yes")


class Config:
    """action.yml surface (getConfig.ts): inputs come from INPUT_*
    env vars (the composite-action convention) with CLI overrides."""

    def __init__(self, args) -> None:
        env = os.environ

        def inp(name, default=""):
            return env.get(f"INPUT_{name.upper().replace('-', '_')}", default)

        self.rules = args.rules or inp("rules")
        self.data = args.data or inp("data")
        self.token = inp("token")
        self.analyze = _bool(args.analyze or inp("analyze", "false"))
        self.create_review = _bool(
            args.create_review or inp("create-review", "false")
        )
        self.path = inp("path")
        self.debug = _bool(inp("debug", "false"))
        self.device = args.device or inp("device")


class GithubContext:
    def __init__(self) -> None:
        env = os.environ
        self.event_name = env.get("GITHUB_EVENT_NAME", "push")
        self.repository = env.get("GITHUB_REPOSITORY", "")
        self.sha = env.get("GITHUB_SHA", "")
        self.ref = env.get("GITHUB_REF", "")
        self.api_url = env.get("GITHUB_API_URL", "https://api.github.com")
        self.payload = {}
        event_path = env.get("GITHUB_EVENT_PATH")
        if event_path and os.path.exists(event_path):
            with open(event_path) as f:
                self.payload = json.load(f)


class GithubApi:
    def __init__(self, token: str, api_url: str) -> None:
        self.token = token
        self.api_url = api_url

    def request(self, method: str, path: str, body: dict = None) -> dict:
        req = urllib.request.Request(
            f"{self.api_url}{path}",
            method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={
                "Authorization": f"Bearer {self.token}",
                "Accept": "application/vnd.github+json",
                "X-GitHub-Api-Version": "2022-11-28",
                "Content-Type": "application/json",
            },
        )
        with urllib.request.urlopen(req) as resp:
            text = resp.read().decode() or "{}"
        return json.loads(text)


def run_validate(cfg: Config) -> dict:
    """handleValidate.ts: structured SARIF validate."""
    w = Writer.buffered()
    code = cli_run(
        [
            "validate",
            "--rules", cfg.rules,
            "--data", cfg.data,
            "--structured",
            "--output-format", "sarif",
            "--show-summary", "none",
            *(["--device", cfg.device] if cfg.device else []),
        ],
        writer=w,
        reader=Reader.from_string(""),
    )
    text = w.stripped()
    if code not in (0, 19):
        # surface validate's own error text (bad paths, parse errors)
        # instead of a JSON decode failure downstream
        raise RuntimeError(w.err_to_stripped().strip() or f"validate exited {code}")
    with open(SARIF_PATH, "w") as f:
        f.write(text)
    return json.loads(text)


def _strip_root(uri: str, root: str) -> str:
    """utils.removeRootPath."""
    prefix = root if root.endswith("/") else root + "/"
    return uri[len(prefix):] if root and uri.startswith(prefix) else uri


def upload_code_scan(api: GithubApi, ctx: GithubContext, sarif: dict) -> None:
    """uploadCodeScan.ts: gzip + base64 the report."""
    payload = gzip.compress(json.dumps(sarif).encode())
    head_commit = (ctx.payload.get("head_commit") or {}).get("id")
    api.request(
        "POST",
        f"/repos/{ctx.repository}/code-scanning/sarifs",
        {
            "commit_sha": head_commit or ctx.sha,
            "ref": ctx.payload.get("ref") or ctx.ref,
            "sarif": base64.b64encode(payload).decode(),
        },
    )


def handle_pull_request_run(api, ctx, cfg, sarif_run) -> list:
    """handlePullRequestRun.ts: restrict to the PR's changed files;
    optionally post review comments (deleting stale duplicates)."""
    pr = ctx.payload.get("pull_request")
    if not pr:
        raise RuntimeError("Pull request number not found in the context")
    number = pr["number"]
    listed = api.request(
        "GET", f"/repos/{ctx.repository}/pulls/{number}/files?per_page=3000"
    )
    files_changed = [f["filename"] for f in listed]
    debug_log(f"Files changed: {files_changed}")

    comments = [
        {
            "body": r["message"]["text"],
            "path": _strip_root(
                r["locations"][0]["physicalLocation"]["artifactLocation"]["uri"],
                cfg.path,
            ),
            "position": r["locations"][0]["physicalLocation"]["region"]["startLine"],
        }
        for r in sarif_run["results"]
    ]
    files_with_violations_in_pr = [
        f for f in files_changed if f in {c["path"] for c in comments}
    ]

    if files_with_violations_in_pr and cfg.create_review:
        existing = api.request(
            "GET", f"/repos/{ctx.repository}/pulls/{number}/comments"
        )
        for comment in comments:
            if comment["path"] not in files_with_violations_in_pr:
                continue
            for prc in existing:
                if (
                    prc.get("body") == comment["body"]
                    and prc.get("path") == comment["path"]
                    and prc.get("position") == comment["position"]
                ):
                    try:
                        api.request(
                            "DELETE",
                            f"/repos/{ctx.repository}/pulls/comments/{prc['id']}",
                        )
                    except Exception as e:  # deletion failure is non-fatal
                        print(e, file=sys.stderr)
            try:
                api.request(
                    "POST",
                    f"/repos/{ctx.repository}/pulls/{number}/reviews",
                    {
                        "comments": [comment],
                        "commit_id": pr["head"]["sha"],
                        "event": "COMMENT",
                        "pull_number": number,
                    },
                )
            except Exception as e:  # out-of-diff positions are skipped
                print(e, file=sys.stderr)

    rows = []
    for r in sarif_run["results"]:
        loc = r["locations"][0]["physicalLocation"]
        uri = loc["artifactLocation"]["uri"]
        if _strip_root(uri, cfg.path) in files_with_violations_in_pr:
            rows.append(
                [
                    f"❌ {uri}:L{loc['region']['startLine']},"
                    f"C{loc['region']['startColumn']}",
                    r["message"]["text"],
                    r["ruleId"],
                ]
            )
    return rows


def handle_push_run(sarif_run) -> list:
    """handlePushRun.ts."""
    rows = []
    for r in sarif_run["results"]:
        loc = r["locations"][0]["physicalLocation"]
        rows.append(
            [
                f"❌ {loc['artifactLocation']['uri']}:"
                f"L{loc['region']['startLine']},C{loc['region']['startColumn']}",
                r["message"]["text"],
                r["ruleId"],
            ]
        )
    return rows


def write_summary(rows: list) -> None:
    """handleWriteActionSummary.ts: job-summary table."""
    lines = ["## Validation Failures", "",
             "| Failure | Message | Rule |", "|---|---|---|"]
    for where, text, rule in rows:
        lines.append(f"| {where} | {text.strip()[:200]} | {rule} |")
    out = "\n".join(lines) + "\n"
    summary_path = os.environ.get("GITHUB_STEP_SUMMARY")
    if summary_path:
        with open(summary_path, "a") as f:
            f.write(out)
    else:
        print(out)


def main(api: GithubApi = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rules", default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--analyze", default=None)
    ap.add_argument("--create-review", dest="create_review", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args([] if api is not None else None)

    cfg = Config(args)
    _DEBUG[0] = cfg.debug
    ctx = GithubContext()
    api = api or GithubApi(cfg.token, ctx.api_url)
    debug_log("Running action")
    debug_log(f"Event type: {ctx.event_name}")

    try:
        sarif = run_validate(cfg)
        sarif_run = sarif["runs"][0]
        if not sarif_run["results"]:
            print("No violations found.")
            return 0
        if cfg.analyze:
            print(f"::error::{VALIDATION_FAILURE} {SECURITY_TAB}")
            upload_code_scan(api, ctx, sarif)
            return 1
        if ctx.event_name == "pull_request":
            rows = handle_pull_request_run(api, ctx, cfg, sarif_run)
        else:
            rows = handle_push_run(sarif_run)
        if rows:
            print(f"::error::{VALIDATION_FAILURE}")
            write_summary(rows)
            return 1
        return 0
    except Exception as e:
        print(f"::error::Action failure: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
