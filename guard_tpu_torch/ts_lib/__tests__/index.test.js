/**
 * Jest tests for the port's npm surface, the counterparts of the JAX
 * package's ts_lib/__tests__. Runs the REAL engine through the CLI,
 * `python -m guard_tpu_torch` from the repo root, with `--device cpu`
 * on `validate` and `serve` so that no card is needed; no engine mocks.
 */
const fs = require("fs");
const os = require("os");
const path = require("path");
const { validate, preflight, EXIT_CODES } = require("../dist/index.js");

const REPO = path.resolve(__dirname, "..", "..", "..");
// a shim that invokes the in-repo CLI; validate() accepts any cliPath
const CLI = path.join(os.tmpdir(), `guard-tpu-torch-test-cli-${process.pid}.sh`);

beforeAll(() => {
  fs.writeFileSync(
    CLI,
    `#!/bin/sh\ncase "$1" in validate|serve) exec python3 -m guard_tpu_torch "$@" --device cpu ;; esac\n` +
      `exec python3 -m guard_tpu_torch "$@"\n`,
    { mode: 0o755 }
  );
  process.env.PYTHONPATH = REPO + (process.env.PYTHONPATH ? ":" + process.env.PYTHONPATH : "");
});

afterAll(() => {
  fs.rmSync(CLI, { force: true });
});

function writeFixtures(dir) {
  fs.mkdirSync(path.join(dir, "rules"), { recursive: true });
  fs.mkdirSync(path.join(dir, "data"), { recursive: true });
  fs.writeFileSync(
    path.join(dir, "rules", "s3.guard"),
    "rule bucket_named { Resources.*.Properties.BucketName exists }\n"
  );
  fs.writeFileSync(
    path.join(dir, "data", "good.json"),
    JSON.stringify({ Resources: { b: { Properties: { BucketName: "x" } } } })
  );
  return dir;
}

test("validate() returns SARIF with real file uris", async () => {
  const dir = writeFixtures(fs.mkdtempSync(path.join(os.tmpdir(), "gt-")));
  const log = await validate({
    rulesPath: path.join(dir, "rules"),
    dataPath: path.join(dir, "data"),
    cliPath: CLI,
  });
  expect(log.version).toBe("2.1.0");
  expect(log.runs.length).toBe(1);
  expect(log.runs[0].tool.driver.name).toBeTruthy();
  fs.rmSync(dir, { recursive: true, force: true });
});

test("failing data yields SARIF results (exit 19 is a result)", async () => {
  const dir = writeFixtures(fs.mkdtempSync(path.join(os.tmpdir(), "gt-")));
  fs.writeFileSync(
    path.join(dir, "data", "bad.json"),
    JSON.stringify({ Resources: { b: { Properties: {} } } })
  );
  const log = await validate({
    rulesPath: path.join(dir, "rules"),
    dataPath: path.join(dir, "data"),
    cliPath: CLI,
  });
  const texts = log.runs[0].results.map((r) => r.message.text).join("\n");
  expect(texts).toContain("bucket_named");
  fs.rmSync(dir, { recursive: true, force: true });
});

test("missing rules path rejects", async () => {
  await expect(
    validate({ rulesPath: "/nonexistent-gt", dataPath: "/tmp", cliPath: CLI })
  ).rejects.toThrow();
});

test("exit-code protocol constants match the CLI's", () => {
  expect(EXIT_CODES).toEqual({ success: 0, validationFailure: 19, error: 5 });
});

describe("preflight", () => {
  test("resolves with the engine banner for a working CLI", async () => {
    const banner = await preflight(CLI);
    expect(banner).toMatch(/^guard-tpu-torch /);
  });

  test("missing CLI raises an actionable install hint", async () => {
    await expect(preflight("/nonexistent/guard-tpu-nope")).rejects.toThrow(
      /pip install guard-tpu/
    );
  });

  test("non-guard-tpu-torch binaries are called out", async () => {
    // /bin/echo answers --version with something else
    await expect(preflight("/bin/echo")).rejects.toThrow(
      /not the guard-tpu-torch CLI/
    );
  });

  test("validate() preflights before walking files", async () => {
    await expect(
      validate({
        rulesPath: "/tmp",
        dataPath: "/tmp",
        cliPath: "/nonexistent/guard-tpu-nope",
      })
    ).rejects.toThrow(/pip install guard-tpu/);
  });
});
