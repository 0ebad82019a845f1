/* The port's C ABI (guard_tpu_torch).
 *
 * The counterpart of the JAX package's native/guard_ffi.h (the
 * reference's guard-ffi crate, lib.rs:32-47): one-shot validate over
 * (data, rules) strings returning a JSON report string, plus the string
 * destructor. The implementation embeds the guard_tpu_torch engine.
 * The types keep the JAX header's names; include one of the two
 * headers in a translation unit.
 */
#ifndef GUARD_TPU_TORCH_FFI_H
#define GUARD_TPU_TORCH_FFI_H

#include <stdbool.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
  const char* content;
  const char* file_name;
} guard_validate_input_t;

typedef struct {
  int32_t code;      /* 0 = ok */
  char* message;     /* owned; free with guard_tpu_torch_free_string */
} guard_extern_err_t;

/* Evaluate `rules` against `data`; returns an owned JSON report string
 * (free with guard_tpu_torch_free_string) or NULL on error (err filled
 * in). */
char* guard_tpu_torch_run_checks(guard_validate_input_t data,
                                 guard_validate_input_t rules, bool verbose,
                                 guard_extern_err_t* err);

void guard_tpu_torch_free_string(char* s);

#ifdef __cplusplus
}
#endif

#endif /* GUARD_TPU_TORCH_FFI_H */
