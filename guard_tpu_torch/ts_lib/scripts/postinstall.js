// guard-tpu-torch postinstall smoke: this npm package drives the
// installed guard-tpu-torch engine (Python) — warn loudly when it is
// absent, but never fail the install (CI images often install the
// engine afterwards).
const { execFile } = require("child_process");

execFile("guard-tpu-torch", ["--version"], { timeout: 30000 }, (err, stdout) => {
  if (err) {
    console.warn(
      "\n[guard-tpu-torch] engine preflight: the 'guard-tpu-torch' CLI was not found on PATH.\n" +
        "[guard-tpu-torch] The npm package is a wrapper; install the engine with:\n" +
        "[guard-tpu-torch]     pip install guard-tpu     (it installs guard-tpu-torch)\n" +
        "[guard-tpu-torch] or pass { cliPath } to validate()/createSession().\n"
    );
    return;
  }
  console.log(`[guard-tpu-torch] engine preflight OK: ${String(stdout).trim()}`);
});
