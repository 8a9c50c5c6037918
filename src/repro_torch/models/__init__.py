"""Models: the param schema and layers (`layers`), the CNN IR + executor
(`graph`), and the LM stack (`attention`, `transformer`)."""
