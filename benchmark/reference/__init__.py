"""The benchmark's plain reference: a frozen checkpoint reader, the scene and
camera path, and a float32 ProNeRF. Nothing here imports the program."""
