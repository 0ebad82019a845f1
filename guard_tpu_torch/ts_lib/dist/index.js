"use strict";
// GENERATED by guard_tpu_torch/tools/ts_build.py from guard_tpu_torch/ts_lib/index.ts — do not edit.
Object.defineProperty(exports, "__esModule", { value: true });
/**
 * guard-tpu-torch npm surface: validate() -> SARIF, plus a persistent
 * session that amortizes engine startup.
 *
 * The npm face of the PyTorch + CUDA port: walk rule/data paths, run a
 * structured SARIF validate, and rewrite result locations to real file
 * names, by driving the installed `guard-tpu-torch` CLI (python) over
 * the payload contract of the JAX package's npm face — one-shot via
 * `validate()`, or through `createSession()`, which keeps ONE
 * `guard-tpu-torch serve --stdio` child alive and streams
 * newline-delimited JSON requests to it, so the Python, PyTorch and
 * CUDA startup is paid once per session instead of once per call.
 *
 * Every call names its backend: `tpuBackend` true or left out passes
 * `--backend tpu` (the device path on the CUDA card, the CLI's own
 * default), false passes `--backend cpu` (the host evaluator, no card
 * needed). On a machine without a card the device path answers code 5.
 *
 * dist/index.js is GENERATED from this file by
 * `python -m guard_tpu_torch.tools.ts_build`; do not edit it by hand.
 */

const { execFile, spawn } = require("child_process");
const { promises: fs } = require("fs");
const path = require("path");

const PREFLIGHT_TIMEOUT_MS = 30000;
const preflightCache = new Map();

function installHint(cli) {
  return (
    `guard-tpu-torch CLI not found at '` + cli + `'.\n` +
    `This npm package drives the installed guard-tpu-torch engine (Python); it\n` +
    `does not bundle it. To fix:\n` +
    `  1. install the engine:  pip install guard-tpu   (it installs guard-tpu-torch)\n` +
    `  2. ensure its bin dir is on PATH (try: guard-tpu-torch --version), or\n` +
    `  3. pass an explicit path: validate({ cliPath: "/path/to/guard-tpu-torch", ... })`
  );
}

/**
 * Check the guard-tpu-torch engine is reachable and answers `--version`.
 * Runs once per distinct cliPath (cached); validate() calls it
 * automatically, and createSession() surfaces the same actionable
 * error through its first rejected request when the spawn fails.
 */
function preflight(cliPath) {
  const cli = cliPath ?? "guard-tpu-torch";
  const cached = preflightCache.get(cli);
  if (cached) return cached;
  const check = new Promise((resolve, reject) => {
    execFile(cli, ["--version"], { timeout: PREFLIGHT_TIMEOUT_MS }, (err, stdout, stderr) => {
      const anyErr = err;
      if (anyErr) {
        preflightCache.delete(cli);
        if (anyErr.code === "ENOENT") {
          reject(new Error(installHint(cli)));
          return;
        }
        if (typeof anyErr.code === "number") {
          // the CLI exists but --version crashed: surface its stderr
          const tail = String(stderr ?? "").trim().slice(-2000);
          reject(
            new Error(
              `guard-tpu-torch preflight: '` + cli + ` --version' exited ` +
                anyErr.code + (tail ? `:\n` + tail : ``)
            )
          );
          return;
        }
        reject(new Error(`guard-tpu-torch preflight failed: ` + anyErr.message));
        return;
      }
      const banner = String(stdout ?? "").trim();
      if (!banner.startsWith("guard-tpu-torch")) {
        preflightCache.delete(cli);
        reject(
          new Error(
            `'` + cli + ` --version' answered '` + banner +
              `' — not the guard-tpu-torch CLI. Point cliPath at the real entry point.`
          )
        );
        return;
      }
      resolve(banner);
    });
  });
  preflightCache.set(cli, check);
  return check;
}

const RULE_EXTENSIONS = new Set([".guard", ".ruleset"]);
const DATA_EXTENSIONS = new Set([".json", ".yaml", ".yml", ".jsn", ".template"]);

async function collectFiles(root, exts) {
  const st = await fs.stat(root);
  if (st.isFile()) return [root];
  const out = [];
  for (const entry of await fs.readdir(root, { withFileTypes: true })) {
    const p = path.join(root, entry.name);
    if (entry.isDirectory()) {
      out.push(...(await collectFiles(p, exts)));
    } else if (exts.has(path.extname(entry.name))) {
      out.push(p);
    }
  }
  return out.sort();
}

function runCli(
  cli,
  args,
  stdin) {
  return new Promise((resolve, reject) => {
    const child = execFile(cli, args, { maxBuffer: 64 * 1024 * 1024 }, (err, stdout, stderr) => {
      const anyErr = err;
      if (anyErr) {
        // validate exits 19 on rule failures — a result, not an error
        if (typeof anyErr.code === "number") {
          resolve({ code: anyErr.code, stdout: stdout ?? "", stderr: stderr ?? "" });
          return;
        }
        if (anyErr.code === "ENOENT") {
          reject(new Error(`guard-tpu-torch CLI not found at '${cli}'`));
          return;
        }
        // spawn failure (EACCES, ...) or signal kill: surface it
        reject(new Error(`guard-tpu-torch CLI failed to run: ${anyErr.message}`));
        return;
      }
      resolve({ code: 0, stdout: stdout ?? "", stderr: stderr ?? "" });
    });
    if (stdin !== undefined && child.stdin) {
      child.stdin.write(stdin);
      child.stdin.end();
    }
  });
}

/**
 * Validate every data file against every rule file; returns the SARIF
 * log (ruleIds/uris refer to the real input file names).
 */
async function validate(input) {
  const cli = input.cliPath ?? "guard-tpu-torch";
  await preflight(cli);
  const ruleFiles = await collectFiles(input.rulesPath, RULE_EXTENSIONS);
  const dataFiles = await collectFiles(input.dataPath, DATA_EXTENSIONS);
  if (ruleFiles.length === 0) throw new Error(`no rule files under ${input.rulesPath}`);
  if (dataFiles.length === 0) throw new Error(`no data files under ${input.dataPath}`);

  const args = [
    "validate",
    "--structured",
    "-S", "none",
    "-o", "sarif",
    "-r", ...ruleFiles,
    "-d", ...dataFiles,
    "--backend", input.tpuBackend === false ? "cpu" : "tpu",
  ];

  const { code, stdout, stderr } = await runCli(cli, args);
  if (code !== 0 && code !== 19) {
    throw new Error(`guard-tpu-torch validate failed (exit ${code}): ${stderr}`);
  }
  return JSON.parse(stdout);
}

/**
 * Start a persistent validate session: spawns `guard-tpu-torch serve
 * --stdio` once and streams one JSON request line per
 * validatePayload() call. Responses arrive in request order
 * (the server handles one line at a time).
 */
function createSession(options) {
  const opts = options ?? {};
  const cli = opts.cliPath ?? "guard-tpu-torch";
  const child = spawn(cli, ["serve", "--stdio"], {
    stdio: ["pipe", "pipe", "pipe"],
  });
  const waiters = [];
  let buffer = "";
  let stderrTail = "";
  let spawnError = null;
  let closed = false;

  child.on("error", (err) => {
    const anyErr = err;
    spawnError =
      anyErr.code === "ENOENT"
        ? new Error(installHint(cli))
        : new Error(`guard-tpu-torch serve failed to start: ${err.message}`);
    while (waiters.length > 0) {
      const w = waiters.shift();
      if (w) w.reject(spawnError);
    }
  });
  // drain stderr (warnings from the Python runtime): an unread pipe
  // would fill and block the child mid-response, hanging the session;
  // keep a bounded tail for diagnostics
  child.stderr.on("data", (chunk) => {
    stderrTail = (stderrTail + String(chunk)).slice(-8192);
  });
  // stdin errors (EPIPE after the child died, write-after-end) must
  // reject the pending promises, not crash the host process
  child.stdin.on("error", (err) => {
    const e = new Error(`guard-tpu-torch serve session broken: ${err.message}`);
    while (waiters.length > 0) {
      const w = waiters.shift();
      if (w) w.reject(e);
    }
  });
  child.stdout.on("data", (chunk) => {
    buffer += String(chunk);
    let idx = buffer.indexOf("\n");
    while (idx >= 0) {
      const line = buffer.slice(0, idx);
      buffer = buffer.slice(idx + 1);
      const w = waiters.shift();
      if (w) {
        try {
          const resp = JSON.parse(line);
          const result = {
            code: resp.code,
            output: resp.output ?? "",
            error: resp.error ?? "",
          };
          if (resp.code === 0 || resp.code === 19) {
            try {
              result.sarif = JSON.parse(resp.output);
            } catch (e) {
              // non-sarif output formats leave sarif unset
            }
          }
          w.resolve(result);
        } catch (e) {
          w.reject(new Error(`malformed serve response: ${line}`));
        }
      }
      idx = buffer.indexOf("\n");
    }
  });
  child.on("close", () => {
    closed = true;
    while (waiters.length > 0) {
      const w = waiters.shift();
      if (w) {
        w.reject(
          spawnError ??
            new Error(
              `guard-tpu-torch serve session closed${stderrTail ? ": " + stderrTail.trim() : ""}`
            )
        );
      }
    }
  });

  function validatePayload(rules, data) {
    return new Promise((resolve, reject) => {
      if (spawnError) {
        reject(spawnError);
        return;
      }
      if (closed || child.exitCode !== null) {
        reject(new Error("guard-tpu-torch serve session is closed"));
        return;
      }
      waiters.push({ resolve: resolve, reject: reject });
      const req = {
        rules: rules,
        data: data,
        output_format: "sarif",
        backend: opts.tpuBackend === false ? "cpu" : "tpu",
      };
      child.stdin.write(JSON.stringify(req) + "\n");
    });
  }

  function close() {
    child.stdin.end();
  }

  return { validatePayload: validatePayload, close: close };
}

/** Exit-code protocol of the wrapped CLI. */
const EXIT_CODES = { success: 0, validationFailure: 19, error: 5 };
exports.preflight = preflight;
exports.validate = validate;
exports.createSession = createSession;
exports.EXIT_CODES = EXIT_CODES;
