"""The port's solver core: problem container, factorizations, sketch
ladders, the padded adaptive engine and its path mode, the
retry/fallback/deadline driver, GLM objectives and the sketched-Newton
driver."""
