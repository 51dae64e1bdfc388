"""GPT models of the port: config, parameters, generation."""
