"""solved_rps: answers of the measured window that the program certified
(OK or RETRIED) and that pass the comparison, over the window's length."""


def read(ctx):
    return ctx.verdict.certified_correct(ctx.answers) / ctx.window_s
