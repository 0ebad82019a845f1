// GENERATED by guard_tpu_torch/tools/ts_build.py from guard_tpu_torch/ts_lib/index.ts — do not edit.
export interface ValidateInput {
  /** Path to a rule file or a directory of .guard files. */
  rulesPath: string;
  /** Path to a data file or a directory of JSON/YAML templates. */
  dataPath: string;
  /** CLI entry point; defaults to `guard-tpu-torch` on PATH. */
  cliPath?: string;
  /** The device path on the CUDA card (`--backend tpu`, the default); false
   * runs the host evaluator (`--backend cpu`). */
  tpuBackend?: boolean;
}
export interface SarifLog {
  version: string;
  $schema: string;
  runs: Array<{
    tool: { driver: { name: string; rules?: unknown[] } };
    results: Array<{
      ruleId?: string;
      message: { text: string };
      locations?: Array<{
        physicalLocation?: {
          artifactLocation?: { uri?: string };
          region?: { startLine?: number; startColumn?: number };
        };
      }>;
    }>;
  }>;
}
export interface SessionOptions {
  /** CLI entry point; defaults to `guard-tpu-torch` on PATH. */
  cliPath?: string;
  /** The device path on the CUDA card (the default); false runs the host
   * evaluator. */
  tpuBackend?: boolean;
}
export interface SessionResult {
  /** Exit-code protocol value: 0 pass / 19 fail / 5 error. */
  code: number;
  /** Parsed SARIF log (sarif format requests only). */
  sarif?: SarifLog;
  /** Raw stdout of the underlying validate. */
  output: string;
  /** Stderr of the underlying validate. */
  error: string;
}
export interface GuardTpuTorchSession {
  /** Validate in-memory rule/data strings; resolves per request. */
  validatePayload(rules: string[], data: string[]): Promise<SessionResult>;
  /** End the session (closes the child's stdin). */
  close(): void;
}
export declare function preflight(cliPath?: string): Promise<string>;
export declare function validate(input: ValidateInput): Promise<SarifLog>;
export declare function createSession(options?: SessionOptions): GuardTpuTorchSession;
export declare const EXIT_CODES: { readonly success: 0; readonly validationFailure: 19; readonly error: 5 };
