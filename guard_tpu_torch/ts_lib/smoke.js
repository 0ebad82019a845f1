/**
 * Dependency-free smoke test for dist/index.js (plain `node
 * guard_tpu_torch/ts_lib/smoke.js`, no jest needed). Exercises
 * validate() and a persistent session end to end against the in-repo
 * CLI and asserts the SARIF contract; exits 0 on success.
 * tests/test_torch_ts_lib.py runs this when node is present.
 *
 * The CLI shim passes `--device cpu` to `validate` and `serve`, so the
 * device path (`--backend tpu`, the package's default) runs the
 * kernels' plain versions on a machine without a card; the host
 * backend (`tpuBackend: false`) is driven too.
 */
const assert = require("assert");
const fs = require("fs");
const os = require("os");
const path = require("path");
const { validate, createSession, EXIT_CODES } = require("./dist/index.js");

const REPO = path.resolve(__dirname, "..", "..");

async function main() {
  const cli = path.join(os.tmpdir(), `guard-tpu-torch-smoke-${process.pid}.sh`);
  fs.writeFileSync(
    cli,
    `#!/bin/sh\ncase "$1" in validate|serve) exec python3 -m guard_tpu_torch "$@" --device cpu ;; esac\n` +
      `exec python3 -m guard_tpu_torch "$@"\n`,
    { mode: 0o755 }
  );
  process.env.PYTHONPATH =
    REPO + (process.env.PYTHONPATH ? ":" + process.env.PYTHONPATH : "");

  const dir = fs.mkdtempSync(path.join(os.tmpdir(), "gtt-smoke-"));
  fs.mkdirSync(path.join(dir, "rules"));
  fs.mkdirSync(path.join(dir, "data"));
  fs.writeFileSync(
    path.join(dir, "rules", "s3.guard"),
    "rule bucket_named { Resources.*.Properties.BucketName exists }\n"
  );
  fs.writeFileSync(
    path.join(dir, "data", "good.json"),
    JSON.stringify({ Resources: { b: { Properties: { BucketName: "x" } } } })
  );
  fs.writeFileSync(
    path.join(dir, "data", "bad.json"),
    JSON.stringify({ Resources: { b: { Properties: {} } } })
  );

  for (const tpuBackend of [undefined, false]) {
    const log = await validate({
      rulesPath: path.join(dir, "rules"),
      dataPath: path.join(dir, "data"),
      cliPath: cli,
      tpuBackend: tpuBackend,
    });
    assert.strictEqual(log.version, "2.1.0");
    assert.strictEqual(log.runs.length, 1);
    const texts = log.runs[0].results.map((r) => r.message.text).join("\n");
    assert.ok(texts.includes("bucket_named"), "failing rule must appear in SARIF");
  }
  assert.deepStrictEqual(EXIT_CODES, {
    success: 0,
    validationFailure: 19,
    error: 5,
  });

  let rejected = false;
  try {
    await validate({ rulesPath: "/nonexistent-gt", dataPath: dir, cliPath: cli });
  } catch (e) {
    rejected = true;
  }
  assert.ok(rejected, "missing rules path must reject");

  console.log("ts_lib smoke OK");

  // persistent session: one `serve --stdio` child, several payload
  // validates, startup paid once
  const session = createSession({ cliPath: cli });
  const pass = await session.validatePayload(
    ["rule ok { a exists }"],
    ['{"a": 1}']
  );
  assert.strictEqual(pass.code, EXIT_CODES.success);
  assert.ok(pass.sarif && pass.sarif.version === "2.1.0");
  const fail = await session.validatePayload(
    ["rule ok { a exists }"],
    ['{"b": 1}']
  );
  assert.strictEqual(fail.code, EXIT_CODES.validationFailure);
  session.close();
  console.log("session smoke OK");

  fs.rmSync(dir, { recursive: true, force: true });
  fs.rmSync(cli, { force: true });
}

main().catch((e) => {
  console.error(e);
  process.exit(1);
});
