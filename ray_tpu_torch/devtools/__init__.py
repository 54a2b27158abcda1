"""Developer tooling that ships with the repo but is not part of the
runtime API surface (static analysis, future codegen/bench helpers)."""
