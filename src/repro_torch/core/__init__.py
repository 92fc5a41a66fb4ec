"""The port's solver core: problem container, factorizations, sketch
ladders, the padded adaptive engine and the retry/fallback/deadline driver."""
