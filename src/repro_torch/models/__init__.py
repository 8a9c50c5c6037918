"""Models: the param schema (`layers`) and the network IR + executor
(`graph`)."""
